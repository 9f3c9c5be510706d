from multigrid_petsc_tpu.parallel.device_mesh import (
    ShardingPlan,
    make_device_mesh,
    make_row_mesh,
    row_plan,
)

__all__ = [
    "ShardingPlan",
    "make_device_mesh",
    "make_row_mesh",
    "row_plan",
]
