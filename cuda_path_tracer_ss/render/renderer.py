"""Progressive renderer: the frame-driver equivalent.

Behavioral spec: ``generateFrame`` + the GL display/accumulation loop
(``CudaTracer/CudaTracer.cu:587-647``, ``CudaUtils.h:145-159``,
``writeToPixelsKernel`` CudaTracer.cu:63-104). Instead of a live GL window,
the renderer accumulates float radiance progressively, exposes per-pass
metrics (the analog of the reference's "Rays per pixel / Time per pass"
console line, CudaTracer.cu:645), writes image files, and can checkpoint /
resume exactly (threefry RNG is counter-based, so resuming at sample k
reproduces the run bit-for-bit — see SURVEY §5 checkpoint/resume).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import DEFAULT_MAX_BOUNCES, LIVE_RAY_CUTOFF
from ..models.camera import Camera
from ..ops import tonemap
from ..utils import image as image_io
from ..utils.profiling import PassMeter
from .engine import FUSED_ENGINES
from .integrator import camera_arrays, render_sample


@dataclasses.dataclass
class RenderConfig:
    """Runtime config — the reference's compile-time constants made runtime
    (SURVEY §5 'Config / flag system')."""

    width: int = 512
    height: int = 512
    max_bounces: int = DEFAULT_MAX_BOUNCES
    spp: int = 64
    seed: int = 0
    live_cutoff: Optional[int] = LIVE_RAY_CUTOFF
    # Samples accumulated per progressive pass. None = AUTO: interactive
    # steps stay small (4 spp) for responsiveness, but ``run()`` on the
    # fused engine GROWS passes 4 -> 8 -> ... -> AUTO_PASS_CAP — the kernel
    # takes spp as a runtime scalar, so one kernel build serves every pass
    # size and long renders amortize the per-pass launch and sync.
    samples_per_pass: Optional[int] = None
    gamma: float = 1.0 / 2.2
    # Engine names and the "auto" rule: render/engine.py. Both engines
    # consume identical counter-based RNG streams (utils/rng.py) so they
    # produce the same image per pixel up to float op-order noise.
    engine: str = "auto"
    # Reference-quirk display pipeline: per-sample clamp -> gamma -> 8-bit
    # quantize -> integer accumulation (writeToPixelsKernel,
    # CudaTracer.cu:63-104). Forces samples_per_pass == 1. The default float
    # pipeline is the correct differentiable form (SURVEY §3.4).
    compat_int_accum: bool = False
    # Spatial acceleration: "none" = linear primitive sweeps (the reference's
    # behavior); "grid" = the jnp engine's per-ray uniform-grid DDA
    # (ops/grid.py — the structure the reference left as a TODO,
    # CudaTracer.cu:437). Identical image either way; its speed on the GPU
    # is not measured yet. The fused kernel has no grid traversal.
    accel: str = "none"
    # optional structured per-pass log (see utils/profiling.PassMeter)
    metrics_jsonl: Optional[str] = None
    # Unbiased estimator mode (ops/shading.shade_physical + the fused
    # kernel's per-lane port): uniform-area light sampling with the correct
    # measure, per-lobe MIS, no emitter double-count. A capability beyond
    # the reference; BOTH engines implement it on shared RNG streams
    # (per-pixel parity, tests/test_pallas_cpu.py).
    physical: bool = False

    def resolved_engine(self) -> str:
        from .engine import resolve_engine
        return resolve_engine(self.engine, self.accel)

    def base_pass_size(self) -> int:
        """Per-step pass size: the explicit setting, or the AUTO base (1 in
        compat mode — it quantizes per sample — else 4)."""
        if self.samples_per_pass is not None:
            return self.samples_per_pass
        return 1 if self.compat_int_accum else 4

    def auto_pass_growth(self) -> bool:
        """True when ``run()`` may grow pass sizes beyond the base: AUTO
        mode on the fused engine (runtime-spp kernel, no recompiles).
        The jnp engine's scan length is static, so it keeps fixed passes."""
        return (self.samples_per_pass is None
                and not self.compat_int_accum
                and self.resolved_engine() in FUSED_ENGINES)


class ProgressiveRenderer:
    """Accumulates samples pass by pass; supports reset (camera moved),
    checkpoint, and resume."""

    def __init__(self, scene, camera: Camera, config: RenderConfig,
                 on_pass: Optional[Callable] = None):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.on_pass = on_pass
        if config.compat_int_accum and config.base_pass_size() != 1:
            raise ValueError("compat_int_accum quantizes per sample; "
                             "set samples_per_pass=1")
        if config.accel not in ("none", "grid"):
            raise ValueError(f"unknown accel {config.accel!r}; "
                             "use 'none' or 'grid'")
        config.resolved_engine()  # refuses a fused engine with the grid
        if config.accel == "grid":
            from ..ops.grid import build_grid
            self._grid = build_grid(scene)
        else:
            self._grid = None
        n = config.width * config.height
        dtype = jnp.uint32 if config.compat_int_accum else jnp.float32
        self._accum = jnp.zeros((n, 3), dtype)
        self._samples_done = 0
        self._seed = jnp.int32(config.seed)
        # Space-key mode switch (CudaTracer.cu:760-765): ray-trace mode caps
        # paths at 1 bounce (usePathTracer=false ran 1 iteration).
        self._ray_trace_mode = False
        self._meter = PassMeter(config.width, config.height,
                                jsonl_path=config.metrics_jsonl)
        self._pass_fn = self._build_pass_fn()

    def _build_pass_fn(self):
        cfg = self.config

        grid = self._grid
        if cfg.compat_int_accum:
            # Reference display pipeline (CudaTracer.cu:63-104). Works on
            # EITHER engine: compat forces samples_per_pass == 1, and the
            # megakernel's mean over spp=1 IS that single sample's radiance,
            # on the same counter-RNG streams the jnp engine uses — engines
            # agree per pixel up to float op order (a sample landing within
            # 1 ulp of an 8-bit quantization boundary can differ by +-1).
            if cfg.resolved_engine() in FUSED_ENGINES:
                from ..ops.pallas.megakernel import (pack_scene,
                                                     render_megakernel)
                interp = cfg.resolved_engine() == "pallas_interpret"
                packed = pack_scene(self.scene)  # concrete pack (see below)

                def one_pass(scene, cam_params, accum, first_sample,
                             bounces, pass_spp):
                    img = render_megakernel(packed, cam_params, self._seed,
                                            cfg.width, cfg.height, 1,
                                            max_bounces=bounces,
                                            sample_offset=first_sample,
                                            interpret=interp,
                                            physical=cfg.physical)
                    return tonemap.compat_accumulate(
                        accum, img.reshape(-1, 3), cfg.gamma)
            else:
                def one_pass(scene, cam_params, accum, first_sample,
                             bounces, pass_spp):
                    r = render_sample(scene, cam_params, cfg.width,
                                      cfg.height, self._seed, first_sample,
                                      max_bounces=bounces,
                                      live_cutoff=cfg.live_cutoff, grid=grid,
                                      physical=cfg.physical)
                    return tonemap.compat_accumulate(accum, r.to_array(),
                                                     cfg.gamma)

            return jax.jit(one_pass, donate_argnums=(2,),
                           static_argnums=(4,))

        if cfg.resolved_engine() in FUSED_ENGINES:
            from ..ops.pallas.megakernel import (pack_scene,
                                                 render_megakernel)
            interp = cfg.resolved_engine() == "pallas_interpret"
            # pack ONCE from the CONCRETE scene: packing inside the jitted
            # pass would trace the material table, which disables the
            # static feature gating (pack_scene keeps every branch for
            # traced tables)
            packed = pack_scene(self.scene)

            accumulate = jax.jit(
                lambda accum, img, n: accum + img.reshape(-1, 3)
                * n.astype(jnp.float32), donate_argnums=(0,))

            def one_pass(scene, cam_params, accum, first_sample, bounces,
                         pass_spp):
                # global sample indices: pass k covers samples
                # [first_sample, first_sample + pass_spp) of the SAME
                # streams the jnp engine would use — resume/engine-switch
                # reproducible. pass_spp, bounces and first_sample are
                # RUNTIME scalars to the kernel, and the kernel is called
                # through its own jit (not inlined into a per-renderer
                # one), so every pass size and every renderer of the same
                # scene and resolution share one compiled build.
                img = render_megakernel(packed, cam_params, self._seed,
                                        cfg.width, cfg.height, pass_spp,
                                        max_bounces=bounces,
                                        sample_offset=first_sample,
                                        interpret=interp,
                                        physical=cfg.physical)
                return accumulate(accum, img, pass_spp)

            return one_pass

        base = cfg.base_pass_size()

        def one_pass(scene, cam_params, accum, first_sample, bounces,
                     pass_spp):
            # jnp engine: the scan length is static, so every pass is the
            # base size (auto growth is a fused-engine feature); pass_spp
            # is accepted for signature parity and ignored
            def body(acc, s):
                r = render_sample(scene, cam_params, cfg.width, cfg.height,
                                  self._seed, s,
                                  max_bounces=bounces,
                                  live_cutoff=cfg.live_cutoff, grid=grid,
                                  physical=cfg.physical)
                return acc + r.to_array(), None

            samples = first_sample + jnp.arange(base)
            accum, _ = jax.lax.scan(body, accum, samples)
            return accum

        return jax.jit(one_pass, donate_argnums=(2,), static_argnums=(4,))

    # -- control --------------------------------------------------------------
    def reset(self):
        """Restart accumulation (the reference's resetTicksThisFrame path,
        CudaTracer.cu:602-608) — call after moving the camera."""
        n = self.config.width * self.config.height
        dtype = jnp.uint32 if self.config.compat_int_accum else jnp.float32
        self._accum = jnp.zeros((n, 3), dtype)
        self._samples_done = 0
        self._meter = PassMeter(self.config.width, self.config.height,
                                jsonl_path=self.config.metrics_jsonl)

    def move_camera(self, key: str) -> bool:
        moved = self.camera.move(key)
        if moved:
            self.reset()
        return moved

    def toggle_ray_trace_mode(self) -> bool:
        """Space-key behavior (CudaTracer.cu:760-765): flip between path
        tracing and 1-bounce ray tracing; accumulation resets. Returns the
        new mode (True = ray-trace)."""
        self._ray_trace_mode = not self._ray_trace_mode
        self.reset()
        return self._ray_trace_mode

    @property
    def effective_bounces(self) -> int:
        return 1 if self._ray_trace_mode else self.config.max_bounces

    def step(self, pass_spp: Optional[int] = None) -> dict:
        """One progressive pass (default: the base pass size — 4 spp in
        AUTO mode, keeping interact/view responsive). ``run()`` passes
        larger ``pass_spp`` on the fused engine to amortize launch
        overhead (same kernel build — spp is a runtime scalar)."""
        cfg = self.config
        n = pass_spp if pass_spp is not None else cfg.base_pass_size()
        if n != cfg.base_pass_size() and not cfg.auto_pass_growth():
            raise ValueError(
                f"pass_spp={n} differs from the configured "
                f"samples_per_pass={cfg.base_pass_size()}; variable pass "
                "sizes need AUTO mode (samples_per_pass=None) on the "
                "fused engine")
        cam_params = camera_arrays(self.camera)
        t0 = time.perf_counter()
        self._accum = self._pass_fn(self.scene, cam_params, self._accum,
                                    jnp.int32(self._samples_done),
                                    self.effective_bounces, jnp.int32(n))
        jax.block_until_ready(self._accum)
        dt = time.perf_counter() - t0
        self._samples_done += n
        metrics = self._meter.record(n, dt)
        if self.on_pass:
            self.on_pass(metrics)
        return metrics

    # AUTO pass schedule: first pass small (fast feedback + compile warm),
    # then double up to this cap. Each pass pays a fixed dispatch + sync
    # cost that long passes amortize; the cap bounds a pass's duration so
    # checkpoint cadence and progress lines stay meaningful.
    AUTO_PASS_CAP = 1024

    def _auto_pass_size(self, s: int) -> int:
        """Size of the scheduled pass covering global sample ``s`` — a pure
        function of s (4, 8, 16, ... doubling to the cap), NOT of restart
        history, so a checkpoint/resume replays the exact pass boundaries
        and the float accumulation order (bit-identical resume, the
        tests/test_cli.py SIGKILL guarantee)."""
        b, n = 0, self.config.base_pass_size()
        while b + n <= s:
            b += n
            n = min(n * 2, self.AUTO_PASS_CAP)
        return b + n - s  # completes the scheduled pass s sits in

    def run(self, total_spp: Optional[int] = None) -> np.ndarray:
        total = total_spp if total_spp is not None else self.config.spp
        base = self.config.base_pass_size()
        if self.config.auto_pass_growth():
            while self._samples_done < total:
                n = min(self._auto_pass_size(self._samples_done),
                        total - self._samples_done)
                m = self.step(n)
                print(self._meter.console_line(m), end="\r", flush=True)
        else:
            remaining = total - self._samples_done
            if remaining > 0 and remaining % base:
                raise ValueError(
                    f"requested {total} spp is not reachable in whole "
                    f"passes of {base} from {self._samples_done}")
            while self._samples_done < total:
                m = self.step()
                print(self._meter.console_line(m), end="\r", flush=True)
        print()
        return self.image()

    # -- output ---------------------------------------------------------------
    def radiance(self) -> np.ndarray:
        """Mean radiance [H,W,3] float32 (row 0 = bottom). In compat mode the
        stored quantity is already display-space; this inverts gamma back to
        an approximate radiance."""
        cfg = self.config
        denom = max(self._samples_done, 1)
        if cfg.compat_int_accum:
            disp = np.asarray(self._accum, np.float32).reshape(
                cfg.height, cfg.width, 3) / (255.0 * denom)
            return disp ** (1.0 / cfg.gamma)
        return np.asarray(self._accum).reshape(cfg.height, cfg.width, 3) / denom

    def image_u8(self) -> np.ndarray:
        """Display image as uint8 [H,W,3]."""
        from .. import native
        cfg = self.config
        if cfg.compat_int_accum:
            return np.asarray(tonemap.compat_display(
                self._accum, max(self._samples_done, 1))).reshape(
                    cfg.height, cfg.width, 3)
        return native.tonemap_u8(self.radiance(), cfg.gamma)

    def image(self) -> np.ndarray:
        return self.image_u8().astype(np.float32) / 255.0

    def save(self, path: str):
        if path.endswith(".npy"):
            image_io.write_npy(path, self.radiance())
            return
        from .. import native
        img_u8 = self.image_u8()
        if path.endswith(".tga"):
            if not native.write_tga(path, img_u8):
                image_io.write_tga(path, img_u8)
        else:
            image_io.write_png(path, img_u8)

    # -- checkpoint / resume --------------------------------------------------
    def _scene_hash(self) -> str:
        """Content hash of the scene the accumulator was averaged over —
        restore refuses to blend two different scenes' samples."""
        import hashlib
        h = hashlib.sha256()
        for leaf in jax.tree_util.tree_leaves(self.scene):
            h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
        return h.hexdigest()[:16]

    def checkpoint(self, path: str):
        np.savez(
            path,
            accum=np.asarray(self._accum),
            samples_done=self._samples_done,
            seed=self.config.seed,
            camera_position=self.camera.position,
            camera_rotation=self.camera.rotation,
            scene_hash=self._scene_hash(),
            engine=self.config.resolved_engine(),
            ray_trace_mode=self._ray_trace_mode,
        )

    def restore(self, path: str):
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        if int(data["seed"]) != self.config.seed:
            raise ValueError("checkpoint seed mismatch — resume would not be exact")
        want_shape = (self.config.width * self.config.height, 3)
        want_dtype = np.uint32 if self.config.compat_int_accum else np.float32
        if data["accum"].shape != want_shape:
            raise ValueError(
                f"checkpoint resolution mismatch: accumulator {data['accum'].shape} "
                f"vs configured {want_shape}")
        if data["accum"].dtype != want_dtype:
            raise ValueError(
                f"checkpoint accumulation mode mismatch: {data['accum'].dtype} "
                f"vs configured {want_dtype.__name__}")
        # Older checkpoints (round 1) predate these fields; validate when
        # present rather than refusing to load them.
        if "scene_hash" in data and str(data["scene_hash"]) != self._scene_hash():
            raise ValueError(
                "checkpoint scene mismatch: the accumulator was rendered "
                "from a different scene — resuming would silently blend "
                "two images")
        if "engine" in data and str(data["engine"]) != self.config.resolved_engine():
            raise ValueError(
                f"checkpoint engine mismatch: saved {data['engine']!r} vs "
                f"configured {self.config.resolved_engine()!r} — RNG streams "
                "are shared but float op order differs; resume with the "
                "same engine for an exact continuation")
        self._accum = jnp.asarray(data["accum"])
        self._samples_done = int(data["samples_done"])
        self.camera.position = data["camera_position"].astype(np.float32)
        self.camera.rotation = data["camera_rotation"].astype(np.float32)
        if "ray_trace_mode" in data:
            self._ray_trace_mode = bool(data["ray_trace_mode"])


def metrics_line(metrics: dict) -> str:
    return json.dumps(metrics)
