# The JAX package's make_mesh, param_sharding, batch_sharding and replicated
# lay a jax.sharding mesh over the devices of one program; the port runs one
# process per device, and its grid of ranks (mesh.py: Mesh, make_mesh,
# gene_dim, param_sharding) takes other arguments, so they are not
# re-exported under those names.
from .mesh import resolve_mesh
from .step import make_sharded_train_step, place_train_state, shard_train_data

__all__ = [
    "resolve_mesh",
    "make_sharded_train_step",
    "shard_train_data",
    "place_train_state",
]
