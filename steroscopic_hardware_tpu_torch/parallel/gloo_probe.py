"""Which gloo collectives take CUDA tensors as they are, unstaged.

    python -m steroscopic_hardware_tpu_torch.parallel.gloo_probe

Two gloo ranks on the card call each collective on CUDA tensors as they
are and check the result against the value it must have: ``multihost``
hands CUDA tensors to gloo's collectives unstaged, and exchanges no
tensor point to point. Rank 0 records each
collective as it finishes ("ok", "wrong values" or the error); send / recv
run last, since a backend that reads a device pointer from the host may
end the process. Prints one JSON line of the records, the card's name
and the torch version.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from steroscopic_hardware_tpu_torch.parallel import multihost

N = 1024


def _checks(rank, dev):
    """(name, function returning whether the result is right) in order."""
    def full(v, dtype):
        return torch.full((N,), v, dtype=dtype, device=dev)

    def all_reduce(dtype):
        x = full(rank + 1, dtype)
        dist.all_reduce(x)
        return bool((x == 3).all())

    def all_gather(dtype):
        parts = [full(0, dtype) for _ in range(2)]
        dist.all_gather(parts, full(rank + 1, dtype))
        return bool((parts[0] == 1).all() and (parts[1] == 2).all())

    def all_to_all(dtype):
        x = torch.cat([full(10 * rank + j, dtype) for j in range(2)])
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return bool((out[:N] == rank).all() and (out[N:] == 10 + rank).all())

    def broadcast(dtype):
        x = full(rank + 7, dtype)
        dist.broadcast(x, src=0)
        return bool((x == 7).all())

    def send_recv(dtype):
        x = full(5 if rank == 0 else 0, dtype)
        if rank == 0:
            dist.send(x, dst=1)
        else:
            dist.recv(x, src=0)
        dist.barrier()
        return bool((x == 5).all())

    out = []
    for fn in (all_reduce, all_gather, all_to_all, broadcast, send_recv):
        for dtype in (torch.float32, torch.bfloat16, torch.uint8):
            if fn is all_reduce and dtype == torch.uint8:
                continue
            name = f"{fn.__name__} {str(dtype)[6:]}"
            out.append((name, lambda fn=fn, dtype=dtype: fn(dtype)))
    return out


def _rank(info, path):
    rank, dev = dist.get_rank(), info["device"]
    for name, check in _checks(rank, dev):
        try:
            torch.cuda.synchronize(dev)
            result = "ok" if check() else "wrong values"
            torch.cuda.synchronize(dev)
        except Exception as e:  # recorded: what the probe is for
            result = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        if rank == 0:
            with open(path, "a") as f:
                f.write(json.dumps({name: result}) + "\n")


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "records.jsonl")
        failed = None
        try:
            multihost.launch(_rank, 2, backend="gloo", device="cuda",
                             args=(path,))
        except Exception as e:  # a rank that died: recorded beside them
            failed = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        records = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    records.update(json.loads(line))
    names = [name for name, _ in _checks(0, "cpu")]
    missing = [n for n in names if n not in records]
    if missing:
        records[missing[0]] = f"the launch ended: {failed}"
    print(json.dumps({"gloo_on_cuda_tensors": records,
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
