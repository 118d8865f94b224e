"""Step functions, the training drivers (``train``: AdamW on one arch;
``fl_train``: the FL launcher with checkpoints), host meshes over the
ranks of a process group (``mesh``) and the sharding rules
(``sharding``).  The JAX package's dry-run tooling is not ported yet."""
