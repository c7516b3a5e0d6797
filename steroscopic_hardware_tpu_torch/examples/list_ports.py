"""Enumerate real serial devices (the counterpart of
``examples/list_ports.py`` and the reference's ``examples/ports``): each
port a camera could be attached to with ``--serial SLOT=DEVICE`` or
``POST /{left,right}/configure device=...``.

    python -m steroscopic_hardware_tpu_torch.examples.list_ports
"""

from __future__ import annotations

from steroscopic_hardware_tpu_torch.runtime.sources import list_serial_ports


def main(argv=None) -> int:
    ports = list_serial_ports()
    if not ports:
        print("no serial ports found")
        return 1
    for p in ports:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
