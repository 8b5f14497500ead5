"""One side of a run: the program (`materialrefgs_torch`) or the reference
(`perfbench.reference.plain`, a frozen plain copy), built from the same
scene. Both packages have the same module names and entry points, so one
builder serves both; it is handed the package's name."""
from __future__ import annotations

import contextlib
import importlib

import torch

PROGRAM = "materialrefgs_torch"
REFERENCE = "perfbench.reference.plain"


class Side:
    """The modules of one package that a cell drives."""

    def __init__(self, package: str):
        self.package = package
        mod = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
        self.config = mod("config")
        self.cameras = mod("cameras")
        self.gm = mod("models.gaussian_model")
        self.env_light = mod("models.env_light")
        self.mesh_tracer = mod("ops.mesh_tracer")
        self.raster_api = mod("ops.rasterize.api")
        self.tracer_api = mod("ops.tracer.api")
        self.renderers = mod("render.renderers")
        self.envgs = mod("render.envgs")
        self.evaluate = mod("evaluate")
        self.trainer = mod("train.trainer")
        self.optim = mod("train.optim")

    def preset(self, cfg: dict):
        model_params, pipe, opt = getattr(self.config, f"preset_{cfg['preset']}")()
        return model_params, pipe, opt

    def camera(self, spec, device):
        return self.cameras.make_camera(spec.R, spec.T, spec.fovx, spec.fovy, spec.width, spec.height,
                                        K=spec.K, device=device)

    def model(self, cloud: dict, alive: torch.Tensor, sh_degree: int, device):
        """A GaussianModel holding copies of the scene's raw parameters."""
        capacity = alive.shape[0]
        model = self.gm.GaussianModel(capacity, sh_degree, device)
        with torch.no_grad():
            for name in self.gm.PARAM_SHAPES:
                getattr(model, name).copy_(cloud[name])
            model.alive.copy_(alive)
            model.active_sh_degree.fill_(sh_degree)
        return model

    def mesh(self, scene, device):
        verts, faces = scene.mesh
        return self.mesh_tracer.build_mesh(verts, faces, device=device)

    def trainer_for(self, cfg: dict, traffic: dict, scene, seed: int, device):
        """The Trainer as scripts/train_torch.py builds it for this preset,
        warm-started at the traffic's start iteration (the CLI's --start_ply
        path: fresh Adam moments, the schedule's clock at the start), with
        the scene's environment cloud and mesh installed. Its own rng (the
        view picks, the warp's neighbours and uniforms) is seeded with the
        traffic's `trainer_seed` where it fixes one, so that every run steps
        through the same views, else with the run's seed."""
        model_params, pipe, opt = self.preset(cfg)
        a = cfg["assumed"]
        sh = int(cfg["sh_degree"])
        model = self.model(scene.main, scene.main_alive, sh, device)
        cams = [self.camera(c, device) for c in scene.train]
        pairs = int(a["pair_capacity"])
        tracer_pairs = int(a.get("tracer_pair_capacity", pairs))
        tr = self.trainer.Trainer(
            model, cams, scene.images, opt, pipe,
            cameras_extent=scene.cameras_extent,
            bg_color=(1.0, 1.0, 1.0) if cfg["white_background"] else (0.0, 0.0, 0.0),
            raster_cfg=self.raster_api.RasterizeConfig(pair_capacity=pairs),
            seed=int(traffic.get("trainer_seed", seed)), envmap_res=int(cfg["envmap_res"]), masks=scene.masks,
            normal_priors=scene.normal_priors, ref_score_masks=scene.ref_score_masks,
            nearest_ids=scene.nearest_ids, with_warp=opt.multi_view_ncc_weight > 0,
            envmap_min_roughness=model_params.envmap_min_roughness,
            envmap_max_roughness=model_params.envmap_max_roughness,
            tracer_cfg=self.tracer_api.TracerConfig(pair_capacity=tracer_pairs,
                                                    cluster_pair_capacity=tracer_pairs >> 7,
                                                    mesh_cull_cap=512, exact_order=True),
            mesh_dir=None,
            use_mesh_visibility=True,
            virtual_cam_trans_noise=model_params.multi_view_max_dis,
            virtual_cam_deg_noise=model_params.multi_view_max_angle,
        )
        st = tr.state
        with torch.no_grad():
            st.env1.base.copy_(scene.env1)
        st.step = int(traffic["start_iteration"]) - 1
        if scene.env is not None:
            st.env_gs = self.model(scene.env, scene.env_alive, sh, device)
            st.env_adam = self.optim.Adam({k: v.detach() for k, v in st.env_params().items()})
        if scene.mesh is not None:
            tr.mesh = self.mesh(scene, device)
        return tr

    def server_for(self, cfg: dict, scene, device) -> dict:
        """What scripts/eval_torch.py serves: the surfel2 model (main cloud,
        environment cloud, cubemap mips, mesh) and its render options."""
        model_params, _, _ = self.preset(cfg)
        sh = int(cfg["sh_degree"])
        a = cfg["assumed"]
        model = self.model(scene.main, scene.main_alive, sh, device)
        env_model = self.model(scene.env, scene.env_alive, sh, device)
        env = self.env_light.EnvLightParams(scene.env1.clone())
        with torch.no_grad():
            mips = self.env_light.EnvLightMips.build(env, min_roughness=model_params.envmap_min_roughness,
                                                     max_roughness=model_params.envmap_max_roughness)
        pairs = int(a["pair_capacity"])
        return {
            "model": model, "env_model": env_model, "mips": mips,
            "mesh": self.mesh(scene, device) if scene.mesh is not None else None,
            "cameras": [self.camera(c, device) for c in scene.test],
            "bg": torch.full((3,), 1.0 if cfg["white_background"] else 0.0, device=device),
            "opts": self.renderers.RenderOptions(raster=self.raster_api.RasterizeConfig(pair_capacity=pairs)),
            # scripts/eval.py's starting budgets: the run's pair capacity and
            # 16384 cluster pairs; a view that overflows is redone.
            "tracer_cfg": self.tracer_api.TracerConfig(pair_capacity=int(a.get("tracer_pair_capacity", pairs)),
                                                       cluster_pair_capacity=1 << 14, mesh_cull_cap=512,
                                                       exact_order=True),
        }

    def serve_view(self, srv: dict, cam_id: int) -> tuple[dict, int]:
        """One served view as evaluate.render_set renders it: render_surfel2
        with the mesh, redone (at most twice) with budgets that fit when its
        traces overflow; the budgets are kept for later views. Returns the
        render and the number of redos."""
        cam = srv["cameras"][cam_id]
        run = lambda cfg: self.envgs.render_surfel2(  # noqa: E731
            srv["model"], srv["env_model"], cam, srv["bg"], srv["mips"], srv["opts"], cfg, mesh=srv["mesh"])
        pkg = run(srv["tracer_cfg"])
        redos = 0
        for _ in range(2):
            if int(pkg.get("tracer_overflow", 0)) == 0:
                break
            srv["tracer_cfg"] = self.evaluate.fit_tracer_budgets(srv["tracer_cfg"], pkg)
            redos += 1
            pkg = run(srv["tracer_cfg"])
        return pkg, redos


def to_uint8(render: torch.Tensor) -> torch.Tensor:
    """The served RGB as eval's PNGs hold it (clamp, x255, round half up),
    still on the device."""
    return (torch.clamp(render, 0.0, 1.0) * 255 + 0.5).to(torch.uint8)


@contextlib.contextmanager
def with_tf32(enabled: bool):
    """TF32 for float32 matmuls and convolutions on (the control) or off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
