"""Multi-host runs (counterpart of ``darwin_tpu/parallel/multihost.py``).

The read stream is the data axis across processes, as it is across a
mesh's devices within one:

* every process loads the reference and builds (or loads) the seed table
  itself — the index is deterministic and cheaper to rebuild than to
  broadcast;
* process r aligns a contiguous block of the reads (``shard_reads``), so
  its SAM / MHAP lines are a contiguous slice of the one-process output,
  and writes them to its own shard file (``shard_path``);
* after a barrier, rank 0 concatenates the shards in rank order
  (``merge_shards``), which reproduces the one-process output exactly, and
  prints the counters summed over the processes (``reduce_counters``).

The alignment loop needs no collective.  The counter sum and the barrier
move host integers only, so ``torch.distributed`` runs on gloo; no code
here needs NCCL.  Each process may drive a mesh of its own cards
(``mesh=``).

    python -m darwin_tpu_torch.parallel.multihost REF READS 0|1 OUT \\
        --coordinator HOST:PORT --num-processes N --process-id R \\
        [--device=cuda|cpu] [--mesh=auto|off|N] [--shard-index]
        [--index-cache=FILE.npz] [--index-layout=pairs|csr]

starts rank R of N (one command per rank, the same coordinator address:
rank 0's host and a free port); ``params.cfg`` in the working directory is
read as the CLI reads it.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

from darwin_tpu_torch.parallel.shard import block


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> tuple[int, int]:
    """Join the process group (gloo, ``tcp://coordinator_address``) when
    there is more than one process; returns (rank, number of
    processes)."""
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_reads(n_reads: int, process_id: int, num_processes: int
                ) -> tuple[int, int]:
    """Contiguous block of the read stream owned by this process:
    [start, stop).  Blocks differ in size by at most one read."""
    return block(n_reads, process_id, num_processes)


def shard_path(out_path: str, process_id: int) -> str:
    return f"{out_path}.shard{process_id:05d}"


def merge_shards(out_path: str, num_processes: int, delete: bool = True):
    """Rank-0 concatenation of per-host output shards, in rank order =
    read order = the single-process output order.  SAM header lines ('@')
    are kept only from the first shard that has them."""
    with open(out_path, "wb") as out:
        header_written = False
        for p in range(num_processes):
            sp = shard_path(out_path, p)
            wrote_header_here = False
            with open(sp, "rb") as f:
                for line in f:
                    if line.startswith(b"@"):
                        if header_written and not wrote_header_here:
                            continue
                        wrote_header_here = True
                    out.write(line)
            header_written = header_written or wrote_header_here
            if delete:
                os.remove(sp)


def reduce_counters(counters: dict) -> dict:
    """The counters summed over every process: one int64 all_reduce
    (exact; darwin_tpu splits each count into 30-bit limbs because its
    transport may have no 64-bit integers).  Python ints."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(counters)
    keys = sorted(counters)
    total = torch.tensor([counters[k] for k in keys], dtype=torch.int64)
    dist.all_reduce(total)
    return {k: int(v) for k, v in zip(keys, total.tolist())}


def run_multihost(ref_path: str, reads_path: str, do_overlap: bool,
                  out_path: str, cfg=None, err=None,
                  coordinator_address: str | None = None,
                  num_processes: int | None = None,
                  process_id: int | None = None,
                  index_cache: str | None = None,
                  index_layout: str | None = None, device="cuda",
                  mesh=None, **run_kw) -> dict:
    """One process's part of a multi-host run: its block of the reads
    aligned on ``device`` (or ``mesh``) into its shard of ``out_path``,
    then, on rank 0, the merged output and the global counters on
    ``err``.  With num_processes None or 1 it is ``pipeline.align.run``
    writing ``out_path``.  ``run_kw`` go to run() (``shard_index``,
    ``spec_k``, ...).  Returns this process's counters."""
    from darwin_tpu_torch.io.fasta import count_reads
    from darwin_tpu_torch.pipeline.align import run

    err = err or sys.stderr
    pid, nproc = init(coordinator_address, num_processes, process_id)
    n_reads = count_reads(reads_path)        # one cheap streaming pass
    start, stop = shard_reads(n_reads, pid, nproc)
    print(f"[host {pid}/{nproc}] reads [{start}, {stop})", file=err)
    local_out = shard_path(out_path, pid) if nproc > 1 else out_path
    with open(local_out, "w") as out:
        counters = run(ref_path, reads_path, do_overlap, cfg=cfg, out=out,
                       err=err, device=device, index_cache=index_cache,
                       index_layout=index_layout, mesh=mesh,
                       reads_range=(start, stop), **run_kw)
    if nproc > 1:
        total = reduce_counters(counters)
        dist.barrier()           # every shard is written and closed
        if pid == 0:
            merge_shards(out_path, nproc)
            print("global counters: "
                  + " ".join(f"{k}={total[k]}" for k in sorted(total)),
                  file=err)
    return counters


def main(argv=None) -> int:
    from darwin_tpu_torch.cli import read_config
    ap = argparse.ArgumentParser(
        prog="python -m darwin_tpu_torch.parallel.multihost",
        description="one rank of a multi-host run")
    ap.add_argument("ref")
    ap.add_argument("reads")
    ap.add_argument("overlap", choices=("0", "1"))
    ap.add_argument("out")
    ap.add_argument("--coordinator", required=True, help="HOST:PORT")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="auto")
    ap.add_argument("--shard-index", action="store_true")
    ap.add_argument("--index-cache")
    ap.add_argument("--index-layout", choices=("pairs", "csr"))
    a = ap.parse_args(argv)
    overlap = a.overlap == "1"
    try:
        run_multihost(a.ref, a.reads, overlap, a.out,
                      cfg=read_config(overlap),
                      coordinator_address=a.coordinator,
                      num_processes=a.num_processes,
                      process_id=a.process_id, index_cache=a.index_cache,
                      index_layout=a.index_layout, device=a.device,
                      mesh=a.mesh if a.mesh in ("auto", "off")
                      else int(a.mesh), shard_index=a.shard_index)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
