"""The port's counterparts of the repository's ``tools/`` that drive the
stereo engines, each run as ``python -m
steroscopic_hardware_tpu_torch.tools.<name>``:

- ``run_sweep``      the block size x maximum disparity grid (BASELINE
                     config #2), Mpix/s per configuration;
- ``run_synth_slam`` VO, BA and loop closure on rendered stress sequences
                     (occluders, photometric jitter, helix), ATE per run;
- ``bench_scaling``  frames per launch on one card, and row-sharded
                     disparity over ranks;
- ``bench_table``    every kernel-table row under the differenced chain;
- ``sgm_bench``      SGM end to end, each stage, and the chain's prefixes;
- ``gen_vectors``    HDL golden vectors from a PNG pair (host numpy).

Each but ``gen_vectors`` takes ``--device {cuda,cpu}``: cuda by default (the hand-written
kernels, raising without a usable GPU), cpu for the plain torch versions.
"""
