"""One rank of the multi-process check: the twin of
``scripts/distributed_worker.py`` on ``torch.distributed``.

Each rank joins the process group, lays the ranks out on a (world, 1)
mesh, runs ``distributed_check``'s problem for ``--iters`` sharded natgrad
+ Adam steps, and prints one JSON line: rank, world size, the final ELBO,
the model's checksum (both equal on every rank, and equal to a
one-process run) and the launches of each hand-written kernel in this
process. On the CPU, two ranks under gloo:

    python -m gpsig_tpu_torch.parallel.worker --init-method file:///tmp/pg \\
        --world-size 2 --rank 0 --backend gloo --device cpu &
    python -m gpsig_tpu_torch.parallel.worker --init-method file:///tmp/pg \\
        --world-size 2 --rank 1 --backend gloo --device cpu

(the store file must not exist beforehand). On one card, two ranks share
it under gloo only (``--device cuda:0`` for both; NCCL refuses two ranks on
one device); with a card a rank, ``--backend nccl --device cuda:<rank>``.
On a card, rank 0 builds the kernel library if it is absent while the
others wait, so that no two ranks run nvcc. ``--arrays`` names an ``.npz``
of the JAX model's leaves (dotted paths), which replaces the port's own
draws of the inducing tensors.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from gpsig_tpu_torch.ops.cuda import launch_counts
from gpsig_tpu_torch.parallel import distributed_check as dc
from gpsig_tpu_torch.parallel.mesh import init_distributed, make_mesh


def build_kernels_once(mesh):
    """Rank 0 builds the kernel library (when absent) while the others
    wait in an ``all_reduce``; then each rank loads the same library."""
    from gpsig_tpu_torch.ops.cuda import _build

    if mesh.rank == 0:
        _build.build()
    dist.all_reduce(torch.zeros(1, device=mesh.device))


def run(mesh, iters, dtype, device, arrays=None):
    """``distributed_check``'s sharded steps on this rank: the JSON line's
    rank, world size, ELBO, checksum and this process's launches."""
    elbo, checksum = dc.run_steps(mesh, iters, dtype, device, arrays)
    return {"rank": mesh.rank, "world_size": mesh.size, "elbo": elbo,
            "checksum": checksum, "launches": launch_counts()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--arrays", default=None)
    parser.add_argument("--dtype", default="float64",
                        choices=("float32", "float64"))
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(args.backend, args.init_method, args.world_size,
                     args.rank)
    try:
        mesh = make_mesh(data=args.world_size, tile=1)
        if device.type == "cuda":
            build_kernels_once(mesh)
        arrays = dict(np.load(args.arrays)) if args.arrays else None
        line = run(mesh, args.iters, getattr(torch, args.dtype), device,
                   arrays)
        print(json.dumps({**line, "backend": args.backend,
                          "device": str(device)}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
