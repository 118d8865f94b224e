"""Step functions for serving (the JAX package's ``launch/`` minus its
mesh, sharding and dry-run tooling, which are not ported yet)."""
