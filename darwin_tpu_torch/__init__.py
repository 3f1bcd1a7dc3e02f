"""darwin_tpu_torch — the PyTorch/CUDA port of darwin_tpu.

The same D-SOFT -> GACT long-read aligner as ``darwin_tpu`` (which stays
in the repository, untouched, as the reference the port is held to), on one
CUDA device.  Plain tensor code is PyTorch; the two GACT tile kernels that
``darwin_tpu`` wrote in Pallas are hand-written CUDA C++ for Hopper
(``csrc/``), each with a plain PyTorch twin that the CPU tests use.

The package never imports jax.  It shares only jax-free host modules of
``darwin_tpu`` (config, genome, native, io.fasta, pipeline.filter, utils).

Layout:
  utils.device  — explicit device resolution (no silent CPU fallback)
  ops           — tile DP + traceback (plain twins, CUDA wrappers, build),
                  tile gather and the filter / extension dispatchers
  index         — minimizer scan + (hash, pos) seed table, pairs layout
  seeding       — D-SOFT on device, host chaining, the batch seeder
  pipeline      — extension manager, SAM printer, Aligner and run()
  cli           — ``python -m darwin_tpu_torch.cli REF READS 0``
"""

__version__ = "0.1.0"
