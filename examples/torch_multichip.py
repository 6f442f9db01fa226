"""Demo: the neuron- and time-sharded Gibbs sweep of pyglm_tpu_torch over
SPMD ranks (latent-distance prior, N=500, as examples/multichip.py runs
the JAX package's over a device mesh).

Every rank runs this same script and gets the same results; rank 0
prints. Two ways to start the ranks:

  torchrun --nproc-per-node 4 examples/torch_multichip.py
      (one rank per card, NCCL; on a CPU box pass --backend gloo)
  python examples/torch_multichip.py --ranks 2 --backend gloo --device cuda:0
      (the script starts its own ranks with parallel.sharding.spawn; ranks
      that share one card need gloo, which NCCL refuses)

--device cpu runs on the CPU (with --backend gloo). The chain of a
sharded model is the unsharded model's Gibbs kernel with other random
streams, so the two traces agree in law, not bit for bit; the script runs
both and prints them side by side.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pyglm_tpu_torch as pt  # noqa: E402
from pyglm_tpu_torch.parallel import sharding  # noqa: E402


def run(args, rank: int, Y, shard: bool):
    model = pt.NonlinearAutoregressiveModel(
        args.N, B=4, L=10, observation="bernoulli",
        network="latent_distance", spike_and_slab=True, seed=0,
        net_kwargs=dict(dim=2), device=sharding.default_device())
    model.add_data(Y)
    if shard:
        model.shard()                      # best_mesh_for over the world
        if rank == 0:
            print(f"mesh: {model._mesh.shape}, backend "
                  f"{model._mesh.backend}")
    lls = []
    t0 = time.perf_counter()
    for it in range(args.sweeps):
        d = model.resample_model()
        lls.append(d["log_likelihood"])
        if rank == 0 and it % 5 == 0:
            print(f"{'sharded' if shard else 'unsharded'} sweep {it}: "
                  f"ll={d['log_likelihood']:.0f} edges={d['n_edges']:.0f}",
                  flush=True)
    return np.asarray(lls), (time.perf_counter() - t0) / args.sweeps


def main(rank: int, world: int, args) -> dict:
    truth = pt.NonlinearAutoregressiveModel(
        args.N, B=4, L=10, observation="bernoulli",
        network="latent_distance", spike_and_slab=True, seed=11,
        net_kwargs=dict(dim=2, mu_bias=-3.0),
        device=sharding.default_device())
    Y = truth.generate(args.T, keep=False)   # the same Y on every rank
    if rank == 0:
        print(f"{world} ranks; rate {Y.mean():.3f} spikes/bin")
    ll_s, s_s = run(args, rank, Y, shard=True)
    ll_u, s_u = run(args, rank, Y, shard=False)
    if rank == 0:
        print(f"log-likelihood, last 5 sweeps: sharded "
              f"{np.round(ll_s[-5:], 0).tolist()}, unsharded "
              f"{np.round(ll_u[-5:], 0).tolist()}")
        print(f"seconds a sweep: sharded {s_s:.3f}, unsharded {s_u:.3f} "
              f"(ranks that share a card are no multi-GPU rate)")
    return {"ll_sharded": ll_s, "ll_unsharded": ll_u}


def _rank(rank, world, args):
    return main(rank, world, args)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=0,
                   help="start this many ranks with spawn (0: the ranks "
                        "torchrun started)")
    p.add_argument("--backend", default=None, help="nccl or gloo")
    p.add_argument("--device", default=None,
                   help="each rank's device for --ranks (default cuda:0 "
                        "where a card is present, else cpu)")
    p.add_argument("--N", type=int, default=500)
    p.add_argument("--T", type=int, default=10_000)
    p.add_argument("--sweeps", type=int, default=25)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    if args.ranks:
        device = args.device or ("cuda:0" if torch.cuda.is_available()
                                 else "cpu")
        sharding.spawn(_rank, args.ranks, backend=args.backend or "gloo",
                       device=device, args=(args,), timeout_s=3600)
    else:
        sharding.init_rank(args.backend)
        import torch.distributed as dist
        try:
            main(dist.get_rank(), dist.get_world_size(), args)
        finally:
            dist.destroy_process_group()
