"""Overrides that shrink each cell to a size the CPU runs in seconds (the
CPU rehearsals and fault tests); every width stays as configured. A
configuration brings its own under the key `tiny` of its file (the keys of
the file to replace); TINY holds those of the configurations that have none."""
TINY = {
    "refnerf": {"config": {"width": 48, "height": 48, "train_views": 24, "test_views": 4, "capacity": 4096,
                           "envmap_res": 16,
                           "assumed": {"main_splats": 1500, "env_splats": 1500, "mesh_triangles": 1280,
                                       "pair_capacity": 1 << 16, "tracer_pair_capacity": 1 << 16}}},
    "refreal": {"config": {"width": 62, "height": 41, "focal_y": 56.0, "capacity": 4096, "envmap_res": 16,
                           "assumed": {"main_splats": 1500, "pair_capacity": 1 << 16}}},
}


def tiny(cell) -> dict:
    """The run overrides ({"config": ...}) that shrink `cell` (a
    manifest.Cell) to its CPU size."""
    name = cell.workload["config"]
    if "tiny" in cell.config:
        return {"config": cell.config["tiny"]}
    if name in TINY:
        return TINY[name]
    raise ValueError(f"configuration {name!r} has no CPU size: give configs/{name}.json a \"tiny\" key "
                     "holding the keys to replace for a CPU run, as the entries of TINY in perfbench/tests/tiny.py do")
