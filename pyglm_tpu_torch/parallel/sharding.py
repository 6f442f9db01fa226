"""Device meshes on torch.distributed (PyTorch counterpart of
``pyglm_tpu/parallel/sharding.py``).

The JAX package runs one controller over a GSPMD mesh. Here every shard is
a process (a rank of ``torch.distributed``) that runs the same script on
its own device: SPMD ranks. A :class:`Mesh` names its axes,
``("time", "neuron")`` for one model, ``("chain",)`` for chains spread over
ranks, or ``("chain", "time", "neuron")`` for both, and holds the axis
sizes, this rank's coordinates, one process group per axis (and one over
the lane axes jointly and one over the whole mesh), the backend and the
rank's device. The Gibbs sweep partitions as in the JAX package:

- **lanes** (the postsynaptic neurons, or the chain-major C*N lanes of a
  stacked ensemble) shard over the lane axes, ``"neuron"`` or
  ``("chain", "neuron")`` jointly: the conditionals of (A, W, b) and the
  PG draws are independent across lanes given the data;
- **time**: X' Omega X, X' u and the log-likelihood are sums over t, so
  the time ranks add their partial sums with :func:`all_reduce_sum`;
- the network prior runs replicated on every rank on (A, W) gathered with
  :func:`all_gather`, from a replicated generator.

The JAX package keeps a trace-time context (``set_active_mesh``,
``active_mesh``, ``local_spmd``) because a Pallas kernel cannot ride
GSPMD. The port has no such context: the mesh is passed down explicitly,
as the ``mesh=`` argument of the sweeps, the weight updates and the PG
draws, and a rank's kernels always run on its own local tiles.

Every public call on a sharded model returns the same global result on
every rank, as the JAX call does; every rank must make it (a collective
waits for all of its group).

Backends: ``"nccl"`` (the default on CUDA) or ``"gloo"`` (the CPU, and
ranks that share one card, which NCCL refuses). Gloo's support of CUDA
tensors differs between builds, so under ``"gloo"`` the collectives copy
CUDA tensors through the host; NCCL's get CPU tensors copied to the
rank's device. The backend is never switched.

Run a sharded script under ``torchrun --nproc-per-node K script.py`` (it
calls :func:`init_rank`) or start the ranks from Python with
:func:`spawn`.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXES = ("time", "neuron")
CHAIN_AXES = ("chain",)
CHAIN_DATA_AXES = ("chain", "time", "neuron")
_MESH_AXES = (DATA_AXES, CHAIN_AXES, CHAIN_DATA_AXES)


class Mesh:
    """A named device mesh over SPMD ranks.

    Ranks map to mesh coordinates row-major over `axis_names` (rank r is
    device r of the JAX package's ``devices.reshape(sizes)``). Built from
    (axis_names, sizes, rank) alone it is a layout, with no process
    groups, for code that only asks which rows and lanes a rank holds;
    :meth:`connect` makes its groups (every rank of the world must call
    it, in the same order). `device` is this rank's device.
    """

    def __init__(self, axis_names, sizes, rank: int = 0, device=None):
        axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
        if axis_names not in _MESH_AXES:
            raise ValueError(f"mesh axes {axis_names}: one of {_MESH_AXES}")
        if len(sizes) != len(axis_names) or min(sizes) < 1:
            raise ValueError(f"mesh sizes {sizes} for axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.size = math.prod(sizes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = dict(zip(axis_names,
                               (int(c) for c in np.unravel_index(rank,
                                                                 sizes))))
        self.device = torch.device(default_device() if device is None
                                   else device)
        self.backend = None
        self._groups = None
        # Collectives that went through a backend, per backend.
        self.collectives = {"gloo": 0, "nccl": 0}

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 for an axis the mesh lacks,
        as the JAX package reads ``mesh.shape.get(axis, 1)``)."""
        return self.coords.get(axis, 0)

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def connect(self, backend: str | None = None) -> "Mesh":
        """Make the process groups of this mesh in the initialised world,
        which the mesh must span. Groups: each axis, the lane axes jointly
        and the whole mesh. `backend` defaults to the world's."""
        if not dist.is_initialized():
            raise ValueError("Mesh.connect: torch.distributed is not "
                             "initialised (init_rank or spawn)")
        world = dist.get_world_size()
        if world != self.size or dist.get_rank() != self.rank:
            raise ValueError(f"a mesh of {self.size} ranks (rank "
                             f"{self.rank}) in a world of {world} (rank "
                             f"{dist.get_rank()}): the mesh must span the "
                             f"world")
        self.backend = backend or dist.get_backend()
        keys = [(a,) for a in self.axis_names]
        lanes = lane_axes(self)
        if len(lanes) > 1:
            keys.append(lanes)
        if len(self.axis_names) > 1:
            keys.append(self.axis_names)
        sizes = tuple(self.shape.values())
        groups = {}
        for key in keys:
            free = [a in key for a in self.axis_names]
            blocks: dict = {}
            for r in range(self.size):
                c = np.unravel_index(r, sizes)
                fixed = tuple(int(x) for x, f in zip(c, free) if not f)
                blocks.setdefault(fixed, []).append(r)
            for fixed in sorted(blocks):     # the same order on every rank
                g = dist.new_group(blocks[fixed], backend=self.backend)
                if self.rank in blocks[fixed]:
                    groups[key] = (g, len(blocks[fixed]))
        self._groups = groups
        return self

    @property
    def connected(self) -> bool:
        return self._groups is not None

    def group(self, axes):
        """(process group, its size) over `axes`."""
        if self._groups is None:
            raise ValueError(f"{self!r} is a layout without process groups; "
                             f"build it in an initialised world")
        return self._groups[self._key(axes)]


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

_RANK_DEVICE = None


def default_device() -> torch.device:
    """This rank's device: the one :func:`init_rank` set, else cuda:(rank
    modulo the card count) where a card is present, else the CPU."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if torch.cuda.is_available():
        rank = dist.get_rank() if dist.is_initialized() else 0
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_rank(backend: str | None = None, device=None,
              init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None,
              timeout_s: float = 600.0) -> torch.device:
    """Initialise this process as a rank: ``init_process_group`` with an
    explicit backend (default "nccl" where a card is present, else "gloo")
    and the rank's device (default cuda:(LOCAL_RANK or rank) modulo the
    card count, or the CPU). Without `init_method`, rank and world size
    come from torchrun's environment (``env://``). Returns the device."""
    global _RANK_DEVICE
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' or 'gloo'")
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if device is None:
        if torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = f"cuda:{local % torch.cuda.device_count()}"
        else:
            device = "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl" and dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    _RANK_DEVICE = dev
    return dev


def _rank_main(fn, rank, world_size, backend, device, init_file, args,
               results, timeout_s):
    try:
        # CPU ranks (tests) run one thread each; ranks on cards split the
        # host's cores, whose work is small host tensors and collectives.
        torch.set_num_threads(1 if str(device).startswith("cpu") else
                              max(1, (os.cpu_count() or 1) // world_size))
        init_rank(backend, device, init_method=f"file://{init_file}",
                  rank=rank, world_size=world_size, timeout_s=timeout_s)
        # As bytes: torch's reductions would pass tensors as shared-memory
        # handles, which die with this process.
        results.put((rank, True, pickle.dumps(fn(rank, world_size, *args))))
    except BaseException:      # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str = "gloo", device=None,
          args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` on `world_size` new ranks and
    return their results, in rank order.

    The ranks start by the ``spawn`` method (the parent may have
    initialised CUDA, which a forked child cannot use), rendezvous through
    a file in a temporary directory (no TCP port to race for), and run
    :func:`init_rank` with `backend` on `device` (one device for every
    rank, e.g. "cuda:0" for ranks that share a card, or a list of one per
    rank; by default each rank's own, as :func:`init_rank` picks it:
    cuda:(rank modulo the card count) where a card is present, else the
    CPU). CPU ranks run one intra-op thread each, ranks on cards split
    the host's cores. `fn` must be importable by name (a module-level
    function) and return picklable values (CPU tensors or arrays). If a
    rank raises, the others are stopped and a RuntimeError carries its
    traceback; so does a rank that has not finished after `timeout_s`
    seconds.
    """
    ctx = mp.get_context("spawn")
    if device is None:
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{r % n_cards}" if n_cards else "cpu"
                   for r in range(world_size)]
    elif isinstance(device, (list, tuple)):
        devices = list(device)
    else:
        devices = [device] * world_size
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pyglm_rdv_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, str(devices[r]),
                                   init_file, tuple(args), results, timeout_s),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) + len(errors) < world_size:
                missing = sorted(set(range(world_size)) - set(out))
                # a rank that died before it reported (a crash while it
                # started) is noticed within seconds, not at the timeout
                dead = [r for r in missing if procs[r].exitcode is not None]
                try:
                    rank, ok, val = results.get(timeout=5.0 if dead else min(
                        1.0, max(0.0, deadline - time.monotonic())))
                except queue.Empty:
                    if dead:
                        errors.append(f"ranks {dead} exited (codes "
                                      f"{[procs[r].exitcode for r in dead]})"
                                      f" without a result")
                        break
                    if time.monotonic() >= deadline:
                        errors.append(f"no result within {timeout_s} s "
                                      f"from ranks {missing}")
                        break
                    continue
                if ok:
                    out[rank] = pickle.loads(val)
                else:
                    errors.append(f"rank {rank}:\n{val}")
                    break
        finally:
            for p in procs:
                p.join(timeout=5 if not errors else 0.5)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
    if errors:
        raise RuntimeError("spawned rank failed: " + "\n".join(errors))
    return [out[r] for r in range(world_size)]


def _world() -> tuple[int, int]:
    """(world size, rank) of the initialised world, or (1, 0)."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _build_mesh(axis_names, sizes) -> Mesh:
    """A mesh of `sizes`, connected when the world is initialised and the
    mesh spans it, else a layout (for this rank where it lies inside the
    mesh, else rank 0)."""
    world, rank = _world()
    n = math.prod(sizes)
    mesh = Mesh(axis_names, sizes, rank=rank if rank < n else 0)
    if dist.is_initialized() and n == world:
        mesh.connect()
    return mesh


def _count(devices) -> int:
    if devices is None:
        return _world()[0]
    if isinstance(devices, (int, np.integer)):
        return int(devices)
    return len(devices)


def make_mesh(n_time: int = 1, n_neuron: int | None = None,
              devices=None) -> Mesh:
    """A ("time", "neuron") mesh. `devices`: a rank count or a sequence of
    ranks (default the initialised world; 1 without one). Defaults to all
    of them on the neuron axis (the embarrassingly parallel one)."""
    n_dev = _count(devices)
    if n_neuron is None:
        n_neuron = n_dev // n_time
    if n_time < 1 or n_neuron < 1 or n_time * n_neuron != n_dev:
        raise ValueError(f"mesh {n_time}x{n_neuron} != {n_dev} devices")
    return _build_mesh(DATA_AXES, (n_time, n_neuron))


def make_chain_mesh(n_chains: int | None = None, devices=None) -> Mesh:
    """A 1-D ("chain",) mesh: independent chains (fit_ensemble) or
    tempering rungs (fit_tempered) spread over ranks, each with the whole
    dataset; the Gibbs pass needs no collectives (models/ensemble.py)."""
    n_dev = _count(devices)
    if n_chains is None:
        n_chains = n_dev
    if not 0 < n_chains <= n_dev:
        raise ValueError(f"a chain mesh of {n_chains} on {n_dev} devices")
    return _build_mesh(CHAIN_AXES, (n_chains,))


def make_chain_data_mesh(n_chain: int, n_time: int = 1,
                         n_neuron: int | None = None, devices=None) -> Mesh:
    """A 3-D ("chain", "time", "neuron") mesh: C chains (or rungs) over
    `n_chain` rank groups, each group running the time/neuron-sharded
    stacked sweep over its ("time", "neuron") sub-grid. The stacked lanes
    shard jointly over ("chain", "neuron"), the sums over "time". Needs C
    divisible by n_chain, N by n_neuron and T by n_time."""
    n_dev = _count(devices)
    if n_neuron is None:
        n_neuron = n_dev // (n_chain * n_time)
    n = n_chain * n_time * n_neuron
    if not 0 < n <= n_dev or min(n_chain, n_time, n_neuron) < 1:
        raise ValueError(f"a {n_chain}x{n_time}x{n_neuron} chain-data mesh "
                         f"on {n_dev} devices")
    return _build_mesh(CHAIN_DATA_AXES, (n_chain, n_time, n_neuron))


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def lane_axes(mesh: Mesh) -> tuple:
    """The mesh axes that shard the postsynaptic-lane dimension of the
    sweep's (T, lanes) arrays, major to minor: "neuron" on a data mesh,
    ("chain", "neuron") jointly on a chain-data mesh (whose lanes are the
    chain-major C*N stack, so a rank's block may straddle two chains)."""
    return tuple(a for a in ("chain", "neuron") if a in mesh.shape)


def lane_count(mesh: Mesh) -> int:
    """The number of ranks that shard the lane axis."""
    return math.prod(mesh.shape[a] for a in lane_axes(mesh))


def lane_index(mesh: Mesh) -> int:
    """This rank's linear index over the lane axes (row-major). Time ranks
    share it: they hold the same lanes."""
    idx = 0
    for a in lane_axes(mesh):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


class ShardLayout(NamedTuple):
    """Which rows of a dataset and which lanes a rank holds."""
    rows: slice       # rows of the dataset's T on this rank
    lanes: slice      # lanes of the sweep's (T, lanes) arrays
    whole: bool       # True: T is not sharded (every time rank holds all)


def time_rows(mesh: Mesh, T: int, L: int = 1) -> tuple[slice, bool]:
    """(rows, whole): this time rank's block of T rows where the time axis
    divides T into blocks of at least `L` rows (the basis filter's halo),
    else all T rows with ``whole`` True on a mesh of several time ranks."""
    n_time = mesh.shape.get("time", 1)
    if T % n_time or T // n_time < L:
        return slice(0, T), n_time > 1
    tl = T // n_time
    t = mesh.index("time")
    return slice(t * tl, (t + 1) * tl), False


def glm_shardings(mesh: Mesh, T: int, n_lanes: int,
                  L: int = 1) -> ShardLayout:
    """The rows of a T-row dataset and the lanes of `n_lanes` that this
    rank holds (the counterpart of the JAX package's NamedShardings):
    lanes in blocks over the lane axes (ValueError if they do not divide
    `n_lanes`), rows as :func:`time_rows` gives them."""
    n_lane = lane_count(mesh)
    if n_lanes % n_lane:
        raise ValueError(f"{n_lanes} lanes are not divisible by the mesh "
                         f"lane axes {lane_axes(mesh)} ({n_lane} ranks)")
    nl = n_lanes // n_lane
    i = lane_index(mesh)
    rows, whole = time_rows(mesh, T, L)
    return ShardLayout(rows, slice(i * nl, (i + 1) * nl), whole)


def lane_slice(mesh: Mesh, n_lanes: int) -> slice:
    """This rank's block of `n_lanes` lanes."""
    return glm_shardings(mesh, 0, n_lanes).lanes


def best_mesh_for(N: int, T=None, devices=None) -> Mesh:
    """The JAX package's mesh choice: the largest divisor of N that fits
    the device count goes on the neuron axis; the remaining factor-of-2
    devices go on the time axis where the dataset length(s) T allow.
    `devices`: a rank count or a sequence (default the initialised
    world)."""
    n_dev = _count(devices)
    Ts = [] if T is None else ([int(T)] if np.isscalar(T)
                               else [int(t) for t in T])
    best = (1, 1)
    nt = 1
    while nt <= n_dev and all(t % nt == 0 for t in Ts):
        for nn in range(1, n_dev // nt + 1):
            if N % nn == 0 and (nt * nn, nn) > (best[0] * best[1], best[1]):
                best = (nt, nn)
        nt *= 2
    n_time, n_neuron = best
    return make_mesh(n_time=n_time, n_neuron=n_neuron,
                     devices=n_time * n_neuron)


def require_mesh(mesh, axes=None) -> Mesh:
    """`mesh` if it is a connected :class:`Mesh` (with the axes `axes`, if
    given), else ValueError."""
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a pyglm_tpu_torch Mesh "
                         f"(parallel.sharding.make_mesh and friends), got "
                         f"{type(mesh).__name__}")
    if axes is not None and mesh.axis_names != tuple(axes):
        raise ValueError(f"mesh axes {mesh.axis_names}, need {tuple(axes)}")
    if not mesh.connected:
        raise ValueError(f"{mesh!r} has no process groups: build it on "
                         f"every rank of an initialised world that it "
                         f"spans")
    return mesh


# ---------------------------------------------------------------------------
# Collectives over one axis (or several jointly)
# ---------------------------------------------------------------------------

def _to_backend(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A contiguous copy of x on a device the backend takes."""
    if mesh.backend == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().to(mesh.device, copy=True).contiguous()


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """x summed over the ranks of `axes` (one axis name or several),
    returned as a new tensor on x's device (x itself where the group is
    one rank under gloo)."""
    g, n = mesh.group(axes)
    if n == 1 and mesh.backend == "gloo":
        return x
    y = _to_backend(x, mesh)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
    mesh.collectives[mesh.backend] += 1
    return y.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' x over `axes`, concatenated along `dim` in the
    row-major order of the axes (a rank's lanes lie at :func:`lane_index`
    times their count). Every rank's x must have one shape."""
    g, n = mesh.group(axes)
    if n == 1 and mesh.backend == "gloo":
        return x
    y = _to_backend(x, mesh)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=g)
    mesh.collectives[mesh.backend] += 1
    return torch.cat(parts, dim=dim).to(x.device)


def time_sum_lanes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per-lane values (lanes on the last axis) summed over "time" and
    gathered over the lane axes, in one all-gather over the whole mesh."""
    parts = all_gather(x[None], mesh, mesh.axis_names)      # (ranks, ...)
    sizes = tuple(mesh.shape.values())
    blocks: dict = {}
    for r in range(mesh.size):
        c = dict(zip(mesh.axis_names, np.unravel_index(r, sizes)))
        i = 0
        for a in lane_axes(mesh):
            i = i * mesh.shape[a] + int(c[a])
        blocks[i] = parts[r] if i not in blocks else blocks[i] + parts[r]
    return torch.cat([blocks[i] for i in sorted(blocks)], dim=-1)


def gather_tree(x, mesh: Mesh, axes, dim: int = 0):
    """:func:`all_gather` over every tensor of a nested tuple / dict (None
    passes)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: gather_tree(v, mesh, axes, dim) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(gather_tree(f, mesh, axes, dim) for f in x))
    return all_gather(x, mesh, axes, dim)


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh gets here."""
    all_reduce_sum(torch.zeros(1, device=mesh.device), mesh,
                   mesh.axis_names)


class LaneShard(NamedTuple):
    """A mesh rank's block `lanes` of the `n_lanes` lanes of the sweep's
    (T, lanes) arrays. Draws that every rank must agree on (the weight
    update's noise and bias normals, a family's auxiliary update) run at
    full width and each rank keeps its lanes; per-lane sums over the
    rank's rows are summed over "time" and gathered over the lane axes.
    `generator` is the replicated host generator of a family's auxiliary
    draws (None where the caller passes its generators itself)."""
    mesh: Mesh
    lanes: slice
    n_lanes: int
    generator: torch.Generator | None = None

    def time_sum(self, x):
        return all_reduce_sum(x, self.mesh, "time")

    def gather(self, x):
        """Lanes of the last axis gathered to full width."""
        return all_gather(x, self.mesh, lane_axes(self.mesh), dim=-1)

    def full(self, x):
        """Per-lane sums (last axis) summed over "time" and gathered."""
        return time_sum_lanes(x, self.mesh)

    def local(self, x):
        return x[..., self.lanes]


def lane_shard(mesh: Mesh, n_lanes: int, generator=None) -> LaneShard:
    """This rank's :class:`LaneShard` of `n_lanes` lanes."""
    return LaneShard(mesh, lane_slice(mesh, n_lanes), int(n_lanes),
                     generator)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

# Per-shard streams: seed + this salt + (shard index + 1) << 16, in the low
# 32 bits that a CPU generator reads, apart from the model's own streams
# (seed), the ensemble's (models/ensemble.py) and the tempered sweep's.
_SHARD_SALT = 0x3A5E0000


def shard_index(mesh: Mesh) -> int:
    """This rank's linear (time, lane) index: time-major, then the lane
    axes, the JAX package's fold order for its per-shard draws."""
    return mesh.index("time") * lane_count(mesh) + lane_index(mesh)


def shard_generators(seed: int, mesh: Mesh, device=None):
    """This rank's per-shard generators, seeded from `seed` and the rank's
    (time, lane) index: the PG draws and K5's CRT counts of its own tile,
    which no other rank repeats."""
    from pyglm_tpu_torch.models.ensemble import chain_generators
    return chain_generators(
        int(seed) + _SHARD_SALT + ((shard_index(mesh) + 1) << 16),
        mesh.device if device is None else device)


# ---------------------------------------------------------------------------
# Models on a mesh
# ---------------------------------------------------------------------------

def make_sharded_sweep(model, mesh: Mesh):
    """The unsharded `model`'s Gibbs sweep on a ("time", "neuron") mesh,
    with this rank's lanes of its state and rows of its datasets: returns
    (sweep, local state, local datas), as the JAX package's returns the
    jitted sweep and the placed state and datas. The sweep is
    ``sweep(MeshGenerators, local state, local datas)``."""
    from pyglm_tpu_torch.models.sweep import make_gibbs_sweep
    require_mesh(mesh, DATA_AXES)
    sweep = make_gibbs_sweep(model.observation, model.network, model.N,
                             model.B, model.spike_and_slab, model.t_chunk,
                             group=model.group, precision=model.precision,
                             mesh=mesh)
    local = [model._ingest(d.Y, mesh) for d in model.datas]
    return sweep, shard_state(model.state, lane_slice(mesh, model.N)), local


def shard_state(state, lanes: slice):
    """A single model's state with only `lanes` of its postsynaptic axis:
    A[:, lanes], W[:, lanes], b[lanes], the aux's lanes; the network state
    is replicated."""
    from pyglm_tpu_torch.models.sweep import GLMState
    return GLMState(state.A[:, lanes].contiguous(),
                    state.W[:, lanes].contiguous(),
                    state.b[lanes].contiguous(),
                    None if state.aux is None else
                    {k: v[lanes].contiguous() for k, v in state.aux.items()},
                    state.net)


def gather_state(state, mesh: Mesh):
    """The whole state of a sharded single model on every rank."""
    from pyglm_tpu_torch.models.sweep import GLMState
    la = lane_axes(mesh)
    return GLMState(all_gather(state.A, mesh, la, dim=1),
                    all_gather(state.W, mesh, la, dim=1),
                    all_gather(state.b, mesh, la, dim=0),
                    None if state.aux is None else
                    {k: all_gather(v, mesh, la, dim=0)
                     for k, v in state.aux.items()},
                    state.net)


def shard_model(model, mesh: Mesh):
    """Re-target a model onto a ("time", "neuron") mesh in place (every
    rank calls it on its copy of the same model). After this, every
    resample_model() runs the sharded sweep on this rank's rows and lanes.

    Each dataset is ingested again on the mesh: a time rank builds its
    rows of the design from its rows of Y and the L bins before them
    (``ops/basis.py::design_matrix_sharded``); a dataset whose T the time
    axis does not divide, or whose shards would be shorter than L, keeps
    its whole rows on every time rank, with a warning, and then only time
    rank 0 sums them (no double count) and the spike-and-slab update runs
    the staged loop. Raises ValueError if N is not divisible by the neuron
    axis."""
    require_mesh(mesh, DATA_AXES)
    if model._mesh is not None:
        raise ValueError("the model is sharded already")
    n_neuron = mesh.shape["neuron"]
    if model.N % n_neuron:
        raise ValueError(
            f"model N={model.N} is not divisible by the mesh neuron axis "
            f"({n_neuron}); use make_mesh(n_neuron=d) with d | N, or "
            f"best_mesh_for(N) to choose one")
    if model.device.type != mesh.device.type:
        raise ValueError(f"the model lives on {model.device}, the mesh's "
                         f"rank on {mesh.device}")
    sweep, state, datas = make_sharded_sweep(model, mesh)
    model._sweep = sweep
    model.state = state
    model.datas = datas
    model.shard_generators = shard_generators(model.seed, mesh,
                                              model.device)
    model._mesh = mesh
    return model


def local_tile(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (T/n_time, lanes/lane_count) tile of a global (T,
    lanes) tensor; ValueError where the mesh does not divide it."""
    if x.ndim != 2:
        raise ValueError(f"a mesh draw needs a (T, lanes) tensor, got "
                         f"shape {tuple(x.shape)}")
    n_time = mesh.shape.get("time", 1)
    if x.shape[0] % n_time or x.shape[1] % lane_count(mesh):
        raise ValueError(f"shape {tuple(x.shape)} is not divisible by the "
                         f"mesh ({n_time} time x {lane_count(mesh)} lane "
                         f"ranks)")
    lay = glm_shardings(mesh, x.shape[0], x.shape[1])
    return x[lay.rows, lay.lanes].contiguous()


def gather_tile(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global tensor from every rank's tile (:func:`local_tile`)."""
    x = all_gather(x, mesh, lane_axes(mesh), dim=1)
    if "time" in mesh.shape:
        x = all_gather(x, mesh, "time", dim=0)
    return x


__all__ = [
    "Mesh", "LaneShard", "ShardLayout", "make_mesh", "make_chain_mesh",
    "make_chain_data_mesh", "best_mesh_for", "lane_axes", "lane_count",
    "lane_index", "lane_slice", "glm_shardings", "time_rows", "shard_model",
    "make_sharded_sweep", "shard_state", "gather_state", "shard_generators",
    "shard_index", "all_reduce_sum", "all_gather", "gather_tree", "barrier",
    "time_sum_lanes", "lane_shard",
    "init_rank", "spawn", "local_tile", "gather_tile", "require_mesh",
    "default_device",
]
