"""Env-sharded rollouts over processes (the port's `rmp_tpu/parallel/`):
`mesh.py` (the ('env',) mesh, the slice of a batch a rank runs, the
sharded rollout with scalar metric all-reduces, the collective audit) and
`distributed.py` (the process group)."""
from rmp_tpu_torch.parallel.mesh import (ENV_AXIS, EnvMesh,  # noqa: F401
                                         audit_collectives, make_mesh,
                                         make_sharded_rollout,
                                         pmean_metrics, record_collectives,
                                         shard_env_batch)
