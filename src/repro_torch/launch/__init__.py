"""Step functions, the training drivers (``train``: AdamW on one arch;
``fl_train``: the FL launcher with checkpoints), host meshes over the
ranks of a process group and the production meshes of the dry-run
(``mesh``), the sharding rules (``sharding``), and the analysis tools:
meta-device specs (``specs``), collective accounting of traced programs
(``collectives``) and the dry-runs (``dryrun``, ``ep_dryrun``,
``fl_dryrun``)."""
