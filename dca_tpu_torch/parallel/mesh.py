"""The ranks of a distributed fit as a ('data', 'model') grid, from the
user's ``devices`` and ``model_parallel`` arguments.

A port of ``resolve_mesh``, ``make_mesh``, ``_gene_spec`` and
``param_sharding`` of the JAX package's ``dca_tpu/parallel/mesh.py`` with
their spellings.  The JAX package lays a ('data', 'model') mesh over the
devices of one program; the port runs one process per device, so its mesh
is the process group that ``multihost.initialize`` joined, laid out as
``make_mesh``'s ``reshape(data, model)``: rank r sits at data index r // M
and model index r % M.  Cells shard over 'data'; with ``model_parallel``
M > 1 the gene dimension shards over 'model' (``gene_dim``): the trunk's
input kernel by rows, the heads' kernels, biases and constant theta by
columns, each only where its gene dimension divides M.  Each rank then
holds its slice of those tensors (``shard_params``) and the whole of every
other one, and a fit ends with every rank holding the whole network again
(``gather_params``).  A call that asks for several devices with no
process group makes one: ``parallel/launch.py`` starts a rank a device
from the calling process, so one process over several GPUs trains on
this same grid.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

# the message of the JAX package's resolve_mesh assertion
NEEDS_DEVICES = "model_parallel > 1 requires devices= ('all', an int, or a list)"

# {(world size, M): (the world group, its data groups, its model groups)}:
# each grid's groups, made once per process group (``make_mesh``)
_GRIDS = {}


def splits(n, model):
    """Whether a gene dimension of ``n`` shards over ``model`` ranks: the
    one layout rule (the JAX package's ``n % M == 0``); a dimension that
    does not split stays whole on every rank."""
    return model > 1 and n % model == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ('data', 'model') grid of the process
    group: ``world`` spans every rank (the loss's (sum, count) pair, the
    gradients of whole tensors, the state broadcast), ``data`` the ranks of
    this model index (BatchNorm's batch statistics, the gradients of gene
    shards), ``model`` the ranks of this data index (the input layer's
    partial products, the gathers of gene shards; None when M is 1)."""

    world: object
    data: object
    model: object
    n_data: int
    n_model: int
    data_index: int
    model_index: int

    @property
    def rank(self):
        return self.data_index * self.n_model + self.model_index

    def shards(self, n):
        """Whether ``n`` genes (an input's or output's columns) shard over
        this grid's model axis (``splits``)."""
        return splits(n, self.n_model)

    def gene_block(self, n):
        """[lo, hi) of this rank's block of ``n`` genes: contiguous shard
        m of M where they shard (``shards``), else every gene (the tensor
        stays whole)."""
        if self.shards(n):
            per = n // self.n_model
            return self.model_index * per, (self.model_index + 1) * per
        return 0, n


def check_grid(world_size, model):
    """Raise, as the JAX package's ``make_mesh`` asserts, unless ``model``
    divides the ``world_size`` ranks."""
    if world_size % model:
        raise ValueError(f"mesh {world_size // model}x{model} != {world_size} devices: "
                         f"model_parallel={model} does not divide the {world_size} ranks")


def make_mesh(world_size, model=1):
    """The ('data', 'model') ``Mesh`` of this rank in an initialized
    process group of ``world_size`` ranks.  The first call for a grid
    creates every data group and then every model group, on every rank in
    the same order, as ``dist.new_group`` needs; later calls under the same
    process group reuse them (a process that fits many times holds one set
    of communicators).  With M = 1 the data group is the world."""
    check_grid(world_size, model)
    n_data = world_size // model
    rank = dist.get_rank()
    world = dist.group.WORLD
    if model == 1:
        return Mesh(world, world, None, n_data, 1, rank, 0)
    made = _GRIDS.get((world_size, model))
    if made is None or made[0] is not world:
        if made is not None:  # a new process group: the old one's groups went with it
            _GRIDS.clear()
        data = [dist.new_group([d * model + m for d in range(n_data)]) for m in range(model)]
        models = [dist.new_group([d * model + m for m in range(model)]) for d in range(n_data)]
        made = _GRIDS[(world_size, model)] = (world, data, models)
    _, data, models = made
    return Mesh(world, data[rank % model], models[rank // model], n_data, model,
                rank // model, rank % model)


def resolve_mesh(devices, model_parallel: int = 1):
    """The ``Mesh`` of ``devices``, or None for the single-device path.

    None/False/0 mean no mesh, where ``model_parallel > 1`` raises as the
    JAX package asserts; ``"all"``/True the ranks of the initialized
    process group; an int N, or a list of N, exactly those ranks, N of
    them.  A world of one rank with ``model_parallel`` 1 is the
    single-device path; a ``Mesh`` is taken as it is (``make_mesh(1)``:
    the sharded step over a group of one, as ``chip_smoke.py``'s phase 14
    runs it).  ``model_parallel`` must divide the ranks.  More
    than one device with no process group is the launcher's to start
    (``parallel/launch.py``, which ``train`` calls first): here it
    raises."""
    if isinstance(devices, Mesh):
        return devices
    model = max(int(model_parallel or 1), 1)
    if devices is None or devices is False or (
        isinstance(devices, int) and not isinstance(devices, bool) and devices == 0
    ):
        if model > 1:
            raise ValueError(NEEDS_DEVICES)
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is True or devices == "all":
        n = world
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(list(devices))
    if n < 1:
        raise ValueError(f"resolve_mesh: no devices in {devices!r}")
    if not dist.is_initialized() and n > 1:
        raise ValueError(f"devices={devices!r}: {n} devices and no process group; train() "
                         "starts their ranks (parallel/launch.py)")
    if n != world:
        raise ValueError(f"devices={devices!r} asks for {n} devices, but the process group "
                         f"has {world} ranks, one per device")
    if world == 1 and model == 1:
        return None
    return make_mesh(world, model)


def rank_devices(devices, device, one_card=False):
    """The device of each rank that a call with ``devices`` starts, rank 0's
    (the network's ``device``) first; None where it starts none: under an
    initialized process group, for no mesh, or for one device.

    An int N is the first N visible CUDA devices, ``"all"`` (or True)
    every visible one, a list its CUDA indices or ``torch.device``\\ s; it
    must start with ``device``'s.  More than are visible raises with the
    JAX package's message.  On the CPU N (or a list of N) is N gloo ranks,
    and ``"all"`` one.  Under torchrun (WORLD_SIZE set) with no group it
    raises rather than start ranks.  ``one_card``: N ranks all on ``device``, over gloo
    (NCCL refuses ranks that share a card)."""
    if dist.is_initialized() or devices is None or devices is False or (
            isinstance(devices, int) and not isinstance(devices, bool) and devices == 0):
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    every = devices is True or devices == "all"
    if device.type == "cpu" or one_card:
        if every and device.type == "cpu":
            return None
        n = devices if isinstance(devices, int) else (
            torch.cuda.device_count() if every else len(list(devices)))
        return _not_under_torchrun(devices, [device] * n) if n > 1 else None
    visible = torch.cuda.device_count()
    if every:
        want = list(range(visible))
    elif isinstance(devices, int):
        if devices > visible:
            raise ValueError(f"requested {devices} devices, only {visible} visible")
        want = list(range(devices))
    else:
        want = [d if isinstance(d, int) else torch.device(d).index or 0 for d in devices]
        if not want or len(set(want)) < len(want) or max(want) >= visible:
            raise ValueError(f"devices={devices!r}: requested {len(want)} devices, only "
                             f"{visible} visible, each named once")
    if want[0] != device.index:
        raise ValueError(f"devices={devices!r} starts with cuda:{want[0]}, but the network "
                         f"is on {device}: rank 0 is the caller and trains on the "
                         "network's device")
    return _not_under_torchrun(devices, [torch.device("cuda", i) for i in want]) \
        if len(want) > 1 else None


def _not_under_torchrun(devices, ranks):
    """``ranks``, unless this process is already one of torchrun's ranks
    (WORLD_SIZE is set) that has not joined its group: each of them would
    start ranks of its own on the same devices."""
    if "WORLD_SIZE" in os.environ:
        raise ValueError(f"devices={devices!r}: this process is rank {os.environ.get('RANK')} "
                         f"of WORLD_SIZE={os.environ['WORLD_SIZE']} (torchrun) and has no "
                         "process group: call dca_tpu_torch.parallel.multihost.initialize() "
                         "before train() (dca() and the CLI do), or run without torchrun and "
                         "let train() start the ranks")
    return ranks


def gene_dim(path, definition, model_size):
    """The dimension of the tensor at ``path`` (its keys, e.g. ``("heads",
    "mean", "kernel")``, or an optimizer state's path to it) that shards
    over 'model', or None where it stays whole: the JAX package's
    ``_gene_spec``.  The trunk's input kernel (G_in, H) shards its rows;
    the heads' (H, G_out) kernels and (1, G_out) theta their columns, their
    (G_out,) biases and elementwise kernels their one dimension; each only
    where its gene dimension divides ``model_size``.  Everything else
    (the trunk past its input kernel, BatchNorm, PReLU, the fork branches,
    the ``*-shared`` (H, 1) heads) stays whole.  The JAX rule picks the
    trunk kernel by its first dimension being G_in; here it is the input
    layer's by name, which is the same tensor unless a hidden width equals
    G_in (where the JAX mesh also lays out a later kernel by rows, a layout
    that changes none of its numbers)."""
    keys = [str(k) for k in path]
    if "trunk" in keys and keys[-1] == "kernel":
        first = definition.shared[0] if definition.shared else None
        if (first is not None and keys[-2] == first.name
                and splits(definition.input_size, model_size)):
            return 0
        return None
    if "heads" in keys:
        head = definition.heads.get(keys[keys.index("heads") + 1])
        if head is None or head.units != definition.output_size:
            return None
        if not splits(definition.output_size, model_size):
            return None
        if keys[-1] == "theta":
            return 1
        if keys[-1] == "kernel" and head.kind == "dense":
            return 1
        return 0  # a bias, or the elementwise pi kernel: (G_out,)
    return None


def param_sharding(network, mesh):
    """{state-dict name: ``gene_dim``} of every parameter of ``network``
    (an ``Autoencoder``): the layout of the parameters and, entry by entry,
    of each per-parameter list of the optimizer state."""
    M = 1 if mesh is None else mesh.n_model
    return {name: gene_dim(name.split("."), network.definition, M)
            for name, _ in network.model.named_parameters()}


def shard_tensor(t, dim, mesh):
    """This rank's block of ``t`` along ``dim`` (a copy), or ``t`` for
    None."""
    if dim is None:
        return t
    lo, hi = mesh.gene_block(t.shape[dim])
    return t.narrow(dim, lo, hi - lo).contiguous()


def gather_tensor(t, dim, mesh):
    """The whole tensor of the ranks' blocks ``t`` along ``dim``, over the
    model group, on every rank; ``t`` for None."""
    if dim is None:
        return t
    blocks = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(blocks, t.detach().contiguous(), group=mesh.model)
    return torch.cat(blocks, dim=dim)


@torch.no_grad()
def _replace(network, mesh, fn):
    dims = param_sharding(network, mesh)
    for name, p in network.model.named_parameters():
        if dims[name] is not None:
            p.data = fn(p.data, dims[name], mesh)
    return dims


def shard_params(network, mesh):
    """Keep this rank's slice of each gene-sharded parameter of
    ``network``, in place (each a new tensor of the slice's shape); the
    whole tensors stay as they are.  ``network.sharded`` then names the
    sharded parameters, the layout every later decision reads (the
    penalties, the gradients' groups).  Call it on the whole network, the
    same on every rank, before the optimizer state is made."""
    dims = _replace(network, mesh, shard_tensor)
    network.mesh = mesh
    network.sharded = frozenset(name for name, d in dims.items() if d is not None)


def gather_params(network, mesh):
    """The inverse of ``shard_params``: every rank holds the whole
    parameters again, gathered over the model group."""
    _replace(network, mesh, gather_tensor)
    network.mesh = None
    network.sharded = frozenset()


def _map_named(fn, named, network, mesh):
    if mesh is None or mesh.n_model == 1:
        return named
    return {path: fn(t, gene_dim(path.replace("/", ".").split("."), network.definition,
                                 mesh.n_model), mesh)
            for path, t in named.items()}


def gather_named(named, network, mesh):
    """{name: tensor} of ``named`` ({"/"- or "."-joined path: tensor} of
    parameters, their gradients or an optimizer state's lists), each
    gene-sharded one gathered whole over the model group; ``named`` as it
    is without a mesh of more than one model index."""
    return _map_named(gather_tensor, named, network, mesh)


def shard_named(named, network, mesh):
    """{name: this rank's block} of the whole tensors in ``named`` (keyed
    as in ``gather_named``)."""
    return _map_named(shard_tensor, named, network, mesh)
