# The JAX package's make_mesh, param_sharding, batch_sharding and replicated
# lay a jax.sharding mesh over the devices of one program; the port runs one
# process per device (mesh.py), so it has no counterpart of them.
from .mesh import resolve_mesh
from .step import make_sharded_train_step, place_train_state, shard_train_data

__all__ = [
    "resolve_mesh",
    "make_sharded_train_step",
    "shard_train_data",
    "place_train_state",
]
