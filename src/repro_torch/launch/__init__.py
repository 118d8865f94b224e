"""Step functions and the training drivers (``train``: AdamW on one
arch; ``fl_train``: the FL launcher with checkpoints).  The JAX package's
mesh, sharding and dry-run tooling is not ported yet."""
