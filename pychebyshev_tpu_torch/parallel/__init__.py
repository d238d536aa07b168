"""Multi-device execution over ``torch.distributed`` device meshes:
``sharding`` (data- and tensor-parallel builds, queries and box
integrals) and ``tt_pipeline`` (pipeline-parallel TT evaluation)."""
