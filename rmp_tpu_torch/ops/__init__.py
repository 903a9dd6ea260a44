from rmp_tpu_torch.ops import geom, linalg  # noqa: F401
