"""The benchmark's inputs, made from the seed on the device.

Everything a cell hands to the program (and, the same, to the reference) is
made here: the main cloud (chip_smoke's bumpy radial shell with random
materials), the environment cloud, the mesh, the cameras, the ground-truth
images of a closed-form reflective sphere under a procedural sky, the masks,
the normal priors, the ref-score masks and the warp's nearest views. The
clouds' values come from one torch.Generator on the device, in a few large
calls; the clouds' geometry, the cameras and the mesh are the same for every
seed (the seed deals the geometry to the slots in its own order), so every
seed asks for the same amount of work.

The scene builders are chip_smoke's (`bench_scene`, `radial_rotations`,
`env_cloud_arrays`, `icosphere`, `bumpy_mesh`), rewritten for torch on the
device and frozen here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

SH_C0 = 0.28209479177387814
# The clouds' geometry (positions, sizes, orientations, opacities) is drawn
# once from this seed; a run's seed deals it to the slots in its own order and
# draws every other value. So every seed asks for the same work: the same
# pairs, the same budgets, the same memory.
GEOMETRY_SEED = 20251018
# Raw parameter shapes of one gaussian (the program's PARAM_SHAPES at SH
# degree 3: K = 16 coefficients).
K_SH = 16
PARAM_SHAPES = {
    "xyz": (3,), "scaling": (2,), "rotation": (4,), "opacity": (1,),
    "refl_strength": (1,), "metalness": (1,), "roughness": (1,), "ori_color": (3,), "diffuse_color": (3,),
    "features_dc": (1, 3), "features_rest": (K_SH - 1, 3), "indirect_dc": (1, 3), "indirect_rest": (K_SH - 1, 3),
    "indirect_asg": (32, 5), "normal1": (3,), "normal2": (3,),
}


@dataclass
class CameraSpec:
    """COLMAP-style extrinsics (R is the world-to-camera rotation's
    transpose, T its translation) and intrinsics; `K` for a pinhole camera."""
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int
    K: np.ndarray | None = None

    @property
    def center(self) -> np.ndarray:
        return -self.R @ self.T


@dataclass
class Scene:
    main: dict  # name -> (capacity, ...) float32 tensor on the device
    main_alive: torch.Tensor
    env1: torch.Tensor  # (6, R, R, 3) cubemap logits
    env: dict | None = None  # the environment cloud's raw parameters
    env_alive: torch.Tensor | None = None
    mesh: tuple | None = None  # (vertices (V, 3) float32, triangles (T, 3) int32), numpy
    train: list = field(default_factory=list)  # CameraSpec
    test: list = field(default_factory=list)
    images: list = field(default_factory=list)  # (H, W, 3) float32 CPU tensors
    masks: list | None = None  # (H, W)
    normal_priors: list | None = None  # (H, W, 3) camera space
    ref_score_masks: list | None = None  # (H, W) 0/1
    nearest_ids: list | None = None
    cameras_extent: float = 1.0


def _logit(p):
    return torch.log(p / (1 - p))


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def radial_rotations(xyz: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) whose surfel normal (the rotation's z axis)
    is the splat's radial direction, with a spin `half` about it: the shell's
    splats lie in the surface, as a converged model's do."""
    n = xyz / torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    q = torch.stack([1.0 + n[:, 2], -n[:, 1], n[:, 0], torch.zeros_like(n[:, 0])], -1)  # +z -> n
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    cw, sz = torch.cos(half), torch.sin(half)
    return torch.stack([q[:, 0] * cw, q[:, 1] * cw + q[:, 2] * sz, q[:, 2] * cw - q[:, 1] * sz,
                        q[:, 0] * sz], -1)


def _empty_cloud(capacity: int, device) -> dict:
    """Raw parameters of empty slots as the program initialises them."""
    cloud = {k: torch.zeros((capacity,) + s, dtype=torch.float32, device=device) for k, s in PARAM_SHAPES.items()}
    cloud["scaling"].fill_(-10.0)
    cloud["opacity"].fill_(-15.0)
    cloud["rotation"][:, 0] = 1.0
    return cloud


def main_cloud(fixed, gen, P: int, capacity: int, device) -> tuple[dict, torch.Tensor]:
    """chip_smoke's bench_scene (bench.py:19-33: splats on a bumpy sphere
    shell), its surfel2 model's radial rotations and random materials. The
    geometry and opacities come from the fixed generator and are dealt to
    the slots in the seed's order, so every seed asks for the same work; the
    materials and colours come from the seed."""
    cloud = _empty_cloud(capacity, device)
    u = _normal(fixed, (P, 3), device)
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    r = 1.0 + 0.1 * _normal(fixed, (P, 1), device)
    xyz = u * r
    geom = {
        "xyz": xyz,
        "scaling": _normal(fixed, (P, 2), device) * 0.3 - 4.2,
        "rotation": radial_rotations(xyz, _uniform(fixed, (P,), 0.0, math.pi, device)),
        "opacity": _logit(_uniform(fixed, (P, 1), 0.3, 0.95, device)),
    }
    perm = torch.randperm(P, generator=gen, device=device)
    for name, v in geom.items():
        cloud[name][:P] = v[perm]
    for name in ("refl_strength", "metalness", "roughness", "ori_color", "diffuse_color"):
        cloud[name][:P] = _normal(gen, (P,) + PARAM_SHAPES[name], device)
    cloud["features_dc"][:P] = (_uniform(gen, (P, 1, 3), 0.05, 0.95, device) - 0.5) / SH_C0
    cloud["features_rest"][:P] = _normal(gen, (P, K_SH - 1, 3), device) * 0.1
    cloud["indirect_dc"][:P] = _normal(gen, (P, 1, 3), device) * 0.5
    cloud["indirect_rest"][:P] = _normal(gen, (P, K_SH - 1, 3), device) * 0.1
    alive = torch.zeros(capacity, dtype=torch.bool, device=device)
    alive[:P] = True
    return cloud, alive


def env_cloud(fixed, gen, P: int, capacity: int, device) -> tuple[dict, torch.Tensor]:
    """chip_smoke's env_cloud_arrays: environment splats, SH degree 3 with
    nonzero higher bands, on a shell of radius 2.2 +- 0.2 around the object;
    geometry fixed and dealt in the seed's order, colours from the seed."""
    cloud = _empty_cloud(capacity, device)
    for name in ("refl_strength", "metalness", "roughness", "ori_color", "diffuse_color"):
        cloud[name][:P] = 0.0
    u = _normal(fixed, (P, 3), device)
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    geom = {
        "xyz": u * _uniform(fixed, (P, 1), 2.0, 2.4, device),
        "scaling": _normal(fixed, (P, 2), device) * 0.2 - 3.9,
        "rotation": _normal(fixed, (P, 4), device),
        "opacity": _logit(_uniform(fixed, (P, 1), 0.3, 0.9, device)),
    }
    perm = torch.randperm(P, generator=gen, device=device)
    for name, v in geom.items():
        cloud[name][:P] = v[perm]
    cloud["features_dc"][:P] = (_uniform(gen, (P, 1, 3), 0.05, 0.95, device) - 0.5) / SH_C0
    cloud["features_rest"][:P] = _normal(gen, (P, K_SH - 1, 3), device) * 0.15
    alive = torch.zeros(capacity, dtype=torch.bool, device=device)
    alive[:P] = True
    return cloud, alive


def icosphere(sub: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (vertices, triangles) with 20 * 4^sub faces; each
    subdivision splits every edge once (vectorised: edges deduplicated by
    np.unique)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
                  [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
                  [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(sub):
        e = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], 1).reshape(-1, 2)
        e.sort(axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mid = len(v) + inv.reshape(-1, 3)  # (F, 3): ab, bc, ca
        v = np.concatenate([v, (v[uniq[:, 0]] + v[uniq[:, 1]]) / 2.0])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = mid[:, 0], mid[:, 1], mid[:, 2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1), np.stack([c, ca, bc], 1),
                            np.stack([ab, bc, ca], 1)])
    return v / np.linalg.norm(v, axis=-1, keepdims=True), f.astype(np.int32)


def bumpy_mesh(sub: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """chip_smoke's bumpy_mesh: an icosphere (81,920 triangles at sub 6)
    displaced to r = 1.05 + 0.3 sin(8x) sin(8y + 1) sin(8z + 2). Its bumps
    reach past the splats' surface, so reflected rays leaving a valley hit
    the neighbouring bumps."""
    v, f = icosphere(sub)
    b = np.sin(8.0 * v[:, 0]) * np.sin(8.0 * v[:, 1] + 1.0) * np.sin(8.0 * v[:, 2] + 2.0)
    return (v * (1.05 + 0.3 * b)[:, None]).astype(np.float32), f


def _look_at(eye: np.ndarray) -> CameraSpec:
    """(R, T) of a camera at `eye` looking at the origin, y up (the Blender
    reader's conversion of an OpenGL camera-to-world matrix)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3].T.copy(), w2c[:3, 3].copy()


def blender_cameras(eyes: list, W: int, H: int, fovx: float) -> list:
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    out = []
    for eye in eyes:
        R, T = _look_at(np.asarray(eye, np.float64))
        out.append(CameraSpec(R, T, fovx, fovy, W, H))
    return out


def pinhole_cameras(eyes: list, W: int, H: int, fy: float, fx: float) -> list:
    K = np.array([[fx, 0.0, W / 2.0], [0.0, fy, H / 2.0], [0.0, 0.0, 1.0]])
    fovx, fovy = 2 * math.atan(W / (2 * fx)), 2 * math.atan(H / (2 * fy))
    out = []
    for eye in eyes:
        R, T = _look_at(np.asarray(eye, np.float64))
        out.append(CameraSpec(R, T, fovx, fovy, W, H, K=K.copy()))
    return out


def hemisphere_eyes(n: int, radius: float) -> list:
    """n points of a Fibonacci lattice on the upper hemisphere (y > 0.05)."""
    out = []
    golden = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(n):
        y = 0.05 + 0.9 * (i + 0.5) / n
        r = math.sqrt(1.0 - y * y)
        out.append(np.array([r * math.cos(golden * i), y, r * math.sin(golden * i)]) * radius)
    return out


def ring_eyes(n: int, radius: float, elevation_deg: float = 0.0, wobble: float = 0.0) -> list:
    """n points on a ring at `elevation_deg`; `wobble` alternates them above
    and below it (chip_smoke's ring_views)."""
    out = []
    el = math.radians(elevation_deg)
    for i in range(n):
        ang = 2 * math.pi * i / n
        eye = np.array([radius * math.cos(el) * math.sin(ang), radius * math.sin(el) + wobble * (-1) ** i,
                        -radius * math.cos(el) * math.cos(ang)])
        out.append(eye / np.linalg.norm(eye) * radius)
    return out


def nearest_view_graph(cams: list, num: int = 8, max_angle: float = 30.0, min_dis: float = 0.01,
                       max_dis: float = 1.5) -> list:
    """Per-camera neighbour ids (the reference's scene/__init__.py:82-118):
    the top `num` by lexsort(angle, distance) with angle < max_angle and
    min_dis < distance < max_dis."""
    centers = np.stack([c.center for c in cams])
    rays = np.stack([c.R @ np.array([0.0, 0.0, 1.0]) for c in cams])
    rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    diss = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    angles = np.arccos(np.clip(np.sum(rays[:, None] * rays[None], axis=-1), -1, 1)) * 180 / 3.14159
    out = []
    for i in range(len(cams)):
        order = np.lexsort((angles[i], diss[i]))
        keep = (angles[i][order] < max_angle) & (diss[i][order] > min_dis) & (diss[i][order] < max_dis)
        out.append([int(j) for j in order[keep][:num]])
    return out


def _sky(d: torch.Tensor) -> torch.Tensor:
    """A procedural sky: a blue gradient over the horizon, a warm ground and
    a sun lobe."""
    y = d[..., 1:2]
    sky = torch.tensor([0.35, 0.55, 0.9], device=d.device) * (0.6 + 0.4 * y.clamp(min=0))
    ground = torch.tensor([0.45, 0.35, 0.25], device=d.device) * (0.5 + 0.5 * (-y).clamp(min=0))
    sun_dir = torch.tensor([0.4, 0.7, -0.59], device=d.device)
    sun_dir = sun_dir / torch.linalg.vector_norm(sun_dir)
    sun = torch.exp(60.0 * ((d * sun_dir).sum(-1, keepdim=True) - 1.0))
    return torch.where(y >= 0, sky, ground) + 2.0 * sun


def render_sphere(cam: CameraSpec, white_background: bool, device) -> dict:
    """The ground truth of one view in closed form: a sphere of radius 1 at
    the origin whose albedo varies over its surface, mixing a Lambertian term
    under the sky's sun with the sky's mirror reflection; the background is
    white (a composited synthetic capture) or the sky (a real one)."""
    W, H = cam.width, cam.height
    fx = W / (2 * math.tan(cam.fovx / 2)) if cam.K is None else cam.K[0, 0]
    fy = H / (2 * math.tan(cam.fovy / 2)) if cam.K is None else cam.K[1, 1]
    ix = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    iy = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    d_cam = torch.stack([(ix + 0.5 - W / 2) / fx, (iy + 0.5 - H / 2) / fy, torch.ones_like(ix)], -1)
    c2w_R = torch.as_tensor(cam.R, dtype=torch.float32, device=device)  # world <- camera
    d = d_cam @ c2w_R.T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(cam.center, dtype=torch.float32, device=device).expand_as(d)
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - torch.sqrt(disc.clamp(min=0))
    hit = hit & (t > 0)
    p = o + t[..., None] * d
    n = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=1e-6)
    refl = d - 2 * (d * n).sum(-1, keepdim=True) * n
    albedo = 0.5 + 0.4 * torch.sin(3.0 * p + torch.tensor([0.0, 2.0, 4.0], device=device))
    metal = 0.5 + 0.5 * torch.sin(5.0 * p[..., 1:2])
    sun_dir = torch.tensor([0.4, 0.7, -0.59], device=device)
    sun_dir = sun_dir / torch.linalg.vector_norm(sun_dir)
    diffuse = albedo * (0.25 + 0.75 * (n * sun_dir).sum(-1, keepdim=True).clamp(min=0))
    color = ((1 - metal) * diffuse + metal * _sky(refl)).clamp(0, 1)
    bg = torch.ones_like(color) if white_background else _sky(d).clamp(0, 1)
    image = torch.where(hit[..., None], color, bg)
    w2c_R = c2w_R.T
    n_cam = n @ w2c_R.T
    return {"image": image, "mask": hit.to(torch.float32),
            "normal": torch.where(hit[..., None], n_cam, torch.zeros_like(n_cam)),
            "ref_score": (hit & (metal[..., 0] > 0.6)).to(torch.float32)}


def make_scene(cfg: dict, traffic: dict, seed: int, device) -> Scene:
    """The cell's inputs from `seed`: the clouds' values from one generator
    on the device, their geometry fixed and dealt in the seed's order; the
    cameras, mesh and ground truth fixed by the configuration."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fixed = torch.Generator(device=device)
    fixed.manual_seed(GEOMETRY_SEED)
    a = cfg["assumed"]
    cap = int(cfg["capacity"])
    main, main_alive = main_cloud(fixed, gen, int(a["main_splats"]), cap, device)
    env1 = _normal(gen, (6, cfg["envmap_res"], cfg["envmap_res"], 3), device)
    scene = Scene(main=main, main_alive=main_alive, env1=env1)
    if a.get("env_splats"):
        scene.env, scene.env_alive = env_cloud(fixed, gen, int(a["env_splats"]), cap, device)
    if a.get("mesh_triangles"):
        sub = round(math.log(int(a["mesh_triangles"]) / 20, 4))
        scene.mesh = bumpy_mesh(sub)
    W, H = int(cfg["width"]), int(cfg["height"])
    if cfg["camera_model"] == "blender":
        fovx = float(cfg["camera_angle_x"])
        r = float(cfg["camera_radius"])
        scene.train = blender_cameras(hemisphere_eyes(int(cfg["train_views"]), r), W, H, fovx)
        scene.test = blender_cameras(ring_eyes(int(cfg["test_views"]), r, float(cfg["test_elevation_deg"])),
                                     W, H, fovx)
    else:
        fy = float(cfg["focal_y"])
        n = int(cfg["train_views"])
        eyes = ring_eyes(n, float(cfg["camera_radius"]), wobble=0.3)
        scene.train = pinhole_cameras(eyes, W, H, fy, fy * float(cfg["focal_x_ratio"]))
        scene.test = scene.train
    if traffic["kind"] == "train":
        # The ground truth, and the per-view inputs that the preset's losses
        # read at the traffic's iteration (its `loss_inputs`).
        gts = [render_sphere(c, bool(cfg["white_background"]), device) for c in scene.train]
        scene.images = [g["image"].cpu() for g in gts]
        wanted = set(traffic.get("loss_inputs", ()))
        if "masks" in wanted:
            scene.masks = [g["mask"].cpu() for g in gts]
        if "normal_priors" in wanted:
            scene.normal_priors = [g["normal"].cpu() for g in gts]
        if "ref_score_masks" in wanted:
            scene.ref_score_masks = [g["ref_score"].cpu() for g in gts]
        scene.nearest_ids = nearest_view_graph(scene.train)
    centers = np.stack([c.center for c in scene.train])
    # getNerfppNorm: 1.1 x the largest distance of a camera from their mean.
    scene.cameras_extent = float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1)))
    return scene
