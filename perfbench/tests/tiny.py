"""Overrides that shrink each cell to a size the CPU runs in seconds (the
CPU rehearsals and fault tests); every width stays as configured."""
TINY = {
    "refnerf": {"config": {"width": 48, "height": 48, "train_views": 24, "test_views": 4, "capacity": 4096,
                           "envmap_res": 16,
                           "assumed": {"main_splats": 1500, "env_splats": 1500, "mesh_triangles": 1280,
                                       "pair_capacity": 1 << 16, "tracer_pair_capacity": 1 << 16}}},
    "refreal": {"config": {"width": 62, "height": 41, "focal_y": 56.0, "capacity": 4096, "envmap_res": 16,
                           "assumed": {"main_splats": 1500, "pair_capacity": 1 << 16}}},
}


def tiny(workload: str) -> dict:
    return TINY[workload.split(".")[0]]
