"""Chain checkpoint and resume (PyTorch counterpart of
``pyglm_tpu/utils/checkpoint.py``): a model's chain state and both of its
generators' states in one ``.npz`` file, so that a resumed chain continues
the same streams exactly, on the CPU and on the card.

The state goes through ``utils/convert.py`` (``state_to_numpy`` /
``state_from_numpy`` with the model's prior), by field name, not by
order. The file also records the model's configuration (N, B, the family,
the prior, spike-and-slab), and loading into a model of another
configuration raises ValueError. The data is not saved: register it again
with ``add_data`` before resuming.

A sharded model (``GLM.shard``) saves its whole state, gathered from the
ranks, its replicated generators and every rank's shard generators; rank
0 writes the file and every rank returns once it is written. Loading it
needs a model sharded on a mesh of the same shape: each rank keeps its
lanes of the state and its own shard generators, so that the resumed
sharded chain continues exactly.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import network_name
from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy


def _config(model) -> dict:
    mesh = getattr(model, "_mesh", None)
    return {"N": model.N, "B": model.B, "observation": model.observation.name,
            "network": network_name(model.network),
            "spike_and_slab": model.spike_and_slab,
            "mesh": None if mesh is None else dict(mesh.shape)}


def _gen_state(g) -> torch.Tensor:
    return g.get_state().to(torch.int64)


def save_state(path, model) -> None:
    """Save `model`'s chain state (A, W, b, aux, the network state) and the
    states of its device and host generators to `path` (.npz); on a
    sharded model also every rank's shard generators (every rank calls
    it; rank 0 writes)."""
    x = state_to_numpy(model._full_state())
    arrays = {"A": x["A"], "W": x["W"], "b": x["b"],
              "config": np.array(json.dumps(_config(model))),
              "gen_device": model.generators.device.get_state().numpy(),
              "gen_host": model.generators.host.get_state().numpy()}
    arrays.update({f"net_{i}": v for i, v in enumerate(x["net"])})
    arrays.update({f"aux_{k}": v for k, v in (x["aux"] or {}).items()})
    mesh = model._mesh
    if mesh is None:
        np.savez(path, **arrays)
        return
    from pyglm_tpu_torch.parallel.sharding import all_gather, barrier
    for name, g in (("shard_gen_device", model.shard_generators.device),
                    ("shard_gen_host", model.shard_generators.host)):
        arrays[name] = all_gather(_gen_state(g)[None], mesh,
                                  mesh.axis_names).to(torch.uint8).numpy()
    if mesh.rank == 0:
        np.savez(path, **arrays)
    barrier(mesh)


def load_state(path, model) -> None:
    """Restore a chain saved by :func:`save_state` into `model`, which must
    have the same configuration (N, B, family, prior, spike-and-slab; else
    ValueError): its state and both generators' states. The next sweep
    continues the saved chain exactly."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    saved, mine = json.loads(str(data["config"])), _config(model)
    saved.setdefault("mesh", None)           # files of unsharded models
    if saved != mine:
        raise ValueError(f"checkpoint {path} holds a chain of another "
                         f"configuration: {saved}, this model is {mine}")
    n_net = sum(k.startswith("net_") for k in data)
    net = tuple(data[f"net_{i}"] for i in range(n_net))
    aux = {k[4:]: v for k, v in data.items() if k.startswith("aux_")}
    model.state = state_from_numpy(data["A"], data["W"], data["b"], net,
                                   device=model.device, aux=aux or None,
                                   network=model.network)
    model.generators.device.set_state(torch.from_numpy(data["gen_device"]))
    model.generators.host.set_state(torch.from_numpy(data["gen_host"]))
    mesh = model._mesh
    if mesh is not None:
        from pyglm_tpu_torch.parallel.sharding import lane_slice, shard_state
        model.state = shard_state(model.state, lane_slice(mesh, model.N))
        r = mesh.rank
        model.shard_generators.device.set_state(
            torch.from_numpy(data["shard_gen_device"][r]))
        model.shard_generators.host.set_state(
            torch.from_numpy(data["shard_gen_host"][r]))
