"""The device mesh and its helpers over torch.distributed (reference:
train_ms.py:71-81, 250-258, DDP over NCCL).

Counterpart of `bert_vits2_tpu/parallel/mesh.py`, with its names. A mesh
has the axes ("data", "model"): each coordinate of the data axis holds a
slice of the global batch's rows (the reference's only strategy), and the
coordinates of the model axis hold the shards of the transformer and
WaveNet stacks (`parallel/sharding.py`, `parallel/tensor.py`).

The JAX package runs one program over the global batch and lets XLA split
it. Here the same mesh comes in two forms:

- several processes (torchrun, `init_distributed`): one rank per mesh
  coordinate, each on its own device. `make_mesh` reads the topology from
  the process group and makes this rank's data and model groups; the train
  step all-reduces over the data group (`parallel/data.py`).
- one process: the mesh holds the devices it was given, and a caller (the
  serving engine) runs one replica per device of the data axis, and its
  BERT's shards on the model-axis devices of the first data coordinate. A
  device may appear twice, as the JAX tests name virtual CPU devices.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from bert_vits2_tpu_torch.parallel.tensor import ModelAxis

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: [n_data, n_model] `torch.device`s. With several processes,
    ranks: the [n_data, n_model] global ranks (rank = data * n_model +
    model), and this rank's coordinate and groups (a group per axis; the
    data group is the whole world when n_model is 1); in one process,
    ranks and the groups are None and the coordinate (0, 0)."""

    devices: np.ndarray
    ranks: np.ndarray | None = None
    data_rank: int = 0
    model_rank: int = 0
    data_group: object | None = None
    model_group: object | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def n_data(self) -> int:
        return self.devices.shape[0]

    @property
    def n_model(self) -> int:
        return self.devices.shape[1]

    @property
    def data_devices(self) -> list[torch.device]:
        """The devices along the data axis (the first model coordinate's)."""
        return list(self.devices[:, 0])

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    @property
    def model_axis(self) -> ModelAxis:
        """This rank's place on the model axis, with its model group. In one
        process the axis has no group (a data coordinate's model-axis
        devices are `devices[d]`)."""
        return ModelAxis(self.model_rank, self.n_model, self.model_group)


def _default_devices() -> list[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def rank_device(rank: int | None = None) -> torch.device:
    """A rank's device: cuda:LOCAL_RANK (torchrun's variable, else the
    rank) modulo the visible cards, or the CPU without one."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                  else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """The [n_data, n_model] mesh. Once torch.distributed is initialized:
    one coordinate per rank, n_data defaulting to world / n_model (their
    product must be the world size), `devices` (one per rank) defaulting to
    each rank's `rank_device`; every rank must call this together (the
    groups are made collectively). Otherwise: `devices` (names or
    `torch.device`s; default every visible card, else the CPU), the first
    n_data * n_model of them."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data is None:
            n_data = world // n_model
        if n_data * n_model != world:
            raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} "
                             f"ranks, not {world}")
        if devices is None:
            devices = [rank_device() if r == rank else rank_device(r)
                       for r in range(world)]
        ranks = np.arange(world).reshape(n_data, n_model)
        data_rank, model_rank = divmod(rank, n_model)
        data_group = dist.group.WORLD if n_model == 1 else None
        model_group = dist.group.WORLD if n_data == 1 else None
        # every rank makes every group, in one order (torch.distributed's rule)
        if data_group is None:
            for m in range(n_model):
                g = dist.new_group(ranks[:, m].tolist())
                if m == model_rank:
                    data_group = g
        if model_group is None:
            for d in range(n_data):
                g = dist.new_group(ranks[d].tolist())
                if d == data_rank:
                    model_group = g
        arr = np.empty(world, dtype=object)
        arr[:] = [torch.device(x) for x in devices[:world]]
        return Mesh(arr.reshape(n_data, n_model), ranks, data_rank, model_rank,
                    data_group, model_group)
    devices = [torch.device(x) for x in (devices if devices is not None
                                         else _default_devices())]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} "
                         f"devices, {len(devices)} given")
    arr = np.empty(n_data * n_model, dtype=object)
    arr[:] = devices[: n_data * n_model]
    return Mesh(arr.reshape(n_data, n_model))


def batch_sharding(mesh: Mesh, rows: int) -> list[tuple[slice, torch.device]]:
    """The rows of a `rows`-row global batch that each data coordinate holds,
    with its device: equal contiguous slices, in coordinate order."""
    n = mesh.n_data
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} data coordinates")
    per = rows // n
    return [(slice(i * per, (i + 1) * per), dev)
            for i, dev in enumerate(mesh.data_devices)]


def shard_batch(mesh: Mesh, batch, index: int | None = None):
    """The rows of data coordinate `index` (default: this rank's) of every
    tensor or numpy array of `batch` (one, or a dict, list or tuple of
    them), along their first axis, on that coordinate's device."""
    if index is None:
        index = mesh.data_rank

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        rows, dev = batch_sharding(mesh, x.shape[0])[index]
        return torch.as_tensor(x[rows]).to(dev)

    return put(batch)


def replicate(mesh: Mesh, tree):
    """Several processes: broadcast the parameters and buffers of `tree`
    (a module, a tensor, or a list or tuple of them; None entries skipped)
    from global rank 0 to every rank, in place, and return tree: a start
    in the full layout, before the model axis shards it.
    One process: `tree` a module, a list with one copy of it per device of
    the data axis (the module itself where it already lies there; one copy
    per distinct device)."""
    if mesh.distributed:
        for t in _tensors(tree):
            dist.broadcast(t.data, 0)
        return tree
    copies = {}
    for dev in mesh.data_devices:
        if dev not in copies:
            copies[dev] = _module_on(tree, dev)
    return [copies[dev] for dev in mesh.data_devices]


def replicate_optimizer(mesh: Mesh, opt: torch.optim.Optimizer) -> None:
    """Several processes: make the optimizer state of global rank 0 every
    rank's, in place (in the full layout, before the model axis shards it):
    which parameters hold state, and each state tensor (Adam's moments and
    step counts), one broadcast per dtype.
    A rank that held other state, or none, takes the source's. `opt` must
    be built alike on every rank, over parameters of the same shapes on
    one device. A no-op in one process."""
    if not mesh.distributed:
        return
    params = [p for g in opt.param_groups for p in g["params"]]
    layout = [None if not opt.state.get(p) else
              [(key, tuple(t.shape), t.dtype, t.device.type == "cpu")
               for key, t in opt.state[p].items() if isinstance(t, torch.Tensor)]
              for p in params]
    box = [layout]
    dist.broadcast_object_list(box, 0)
    tensors = []
    for p, entries in zip(params, box[0]):
        if entries is None:
            opt.state.pop(p, None)
            continue
        state = opt.state[p]
        for key, shape, dtype, on_cpu in entries:
            dev = torch.device("cpu") if on_cpu else p.device
            t = state.get(key)
            if not (isinstance(t, torch.Tensor) and tuple(t.shape) == shape
                    and t.dtype == dtype and t.device == dev):
                t = state[key] = torch.empty(shape, dtype=dtype, device=dev)
            tensors.append(t)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group_ts = [t for t in tensors if t.dtype == dtype]
        # flat, on the parameters' device: NCCL takes no host tensor
        flat = torch.cat([t.reshape(-1).to(params[0].device) for t in group_ts])
        dist.broadcast(flat, 0)
        for t, part in zip(group_ts, flat.split([t.numel() for t in group_ts])):
            t.copy_(part.view(t.shape))


def _tensors(tree):
    if tree is None:
        return
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    else:
        yield tree


def _module_on(module: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """The module itself if its tensors lie on `dev`, else a copy there."""
    if all(t.device == dev or (t.device.type == dev.type and dev.index is None)
           for t in _tensors(module)):
        return module
    # a weight-normed conv holds its last computed weight, a non-leaf tensor
    # that deepcopy refuses: the copy leaves it out, and the weight-norm hook
    # computes it anew at the copy's first forward
    memo = {id(sub.weight): None for sub in module.modules() if hasattr(sub, "weight_g")}
    return copy.deepcopy(module, memo).to(dev)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group (the reference's torchrun + env:// bring-up,
    train_ms.py:74) -> whether several processes run.

    The arguments default to torchrun's variables: WORLD_SIZE, RANK, and
    MASTER_ADDR:MASTER_PORT (read by env://); `coordinator_address`
    "host:port" replaces the last. A no-op with one process, as the JAX
    function is, and when the group is already initialized. backend:
    "nccl" or "gloo"; by default NCCL where each of this host's ranks
    (torchrun's LOCAL_WORLD_SIZE) has a card of its own, else gloo (no
    card, or ranks sharing one: NCCL takes one rank per card). A backend
    that is asked for and unavailable raises. Under NCCL the rank's card
    (`rank_device`) becomes the current device."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        backend = ("nccl" if torch.cuda.is_available()
                   and local <= torch.cuda.device_count() else "gloo")
    available = {"nccl": dist.is_nccl_available() and torch.cuda.is_available(),
                 "gloo": dist.is_gloo_available()}
    if not available.get(backend, False):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available "
                           "here" + (" (no CUDA device)" if backend == "nccl" else ""))
    if backend == "nccl":
        torch.cuda.set_device(rank_device(int(os.environ.get("LOCAL_RANK", process_id))))
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return True
