"""darwin_tpu_torch — the PyTorch/CUDA port of darwin_tpu.

The same D-SOFT -> GACT long-read aligner as ``darwin_tpu`` (which stays
in the repository, untouched, as the reference the port is held to), on a
CUDA device, a mesh of them, or several processes.  Plain tensor code is PyTorch; every kernel that ``darwin_tpu``
wrote in Pallas is hand-written CUDA C++ for Hopper (``csrc/``), each with
a plain PyTorch twin that the CPU tests use.

The package imports neither jax nor ``darwin_tpu``: it keeps its own copy
of every host module it needs (config, genome, native + its C++ source,
io.fasta, pipeline.filter, utils.simulate), each naming its origin.

Layout:
  utils.device  — explicit device resolution (no silent CPU fallback)
  config, genome, io.fasta, native — params.cfg, sequence store, FASTA
                  reading, the g++-built host library
  ops           — tile DP + traceback (plain twins, CUDA wrappers, build),
                  tile gather and the filter / extension dispatchers
  index         — minimizer scan + (hash, pos) seed table, pairs layout
  seeding       — D-SOFT on device, host chaining, the batch seeder
  pipeline      — filter, extension manager, SAM / MHAP printer, Aligner
                  and run()
  parallel      — meshes (tile batches split over devices), the seed table
                  sharded by hash range, multi-host runs
  tools         — the int32 op-rate probe
  cli           — ``python -m darwin_tpu_torch.cli REF READS 0|1``
"""

__version__ = "0.1.0"
