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
"""
from __future__ import annotations

import json

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import network_name
from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy


def _config(model) -> dict:
    return {"N": model.N, "B": model.B, "observation": model.observation.name,
            "network": network_name(model.network),
            "spike_and_slab": model.spike_and_slab}


def save_state(path, model) -> None:
    """Save `model`'s chain state (A, W, b, aux, the network state) and the
    states of its device and host generators to `path` (.npz)."""
    x = state_to_numpy(model.state)
    arrays = {"A": x["A"], "W": x["W"], "b": x["b"],
              "config": np.array(json.dumps(_config(model))),
              "gen_device": model.generators.device.get_state().numpy(),
              "gen_host": model.generators.host.get_state().numpy()}
    arrays.update({f"net_{i}": v for i, v in enumerate(x["net"])})
    arrays.update({f"aux_{k}": v for k, v in (x["aux"] or {}).items()})
    np.savez(path, **arrays)


def load_state(path, model) -> None:
    """Restore a chain saved by :func:`save_state` into `model`, which must
    have the same configuration (N, B, family, prior, spike-and-slab; else
    ValueError): its state and both generators' states. The next sweep
    continues the saved chain exactly."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    saved, mine = json.loads(str(data["config"])), _config(model)
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
