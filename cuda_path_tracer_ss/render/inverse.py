"""Differentiable rendering: gradients, FD checking, inverse rendering.

The reference is forward-only; differentiability is a new capability of
this JAX build (BASELINE.json north star: dL/d(material params, light emission,
camera) match finite differences; config 4: recover albedo/roughness/light
emission via pixel-gradient descent). The whole estimator is pure JAX, so
``jax.grad`` flows through the bounce scan; discrete branch/hit decisions
are detached and continuous factors reparameterized (see ops/bsdf.py), so
expected gradients match finite differences on the same random streams.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..constants import DEFAULT_MAX_BOUNCES
from ..models.scene import Scene
from ..utils import rng
from .integrator import render

# Scene leaves it makes sense to optimize. Names address nested dataclass
# fields with dots; Vec3 leaves are exposed as [.., 3] arrays for optimizers.
TRAINABLE_FIELDS = (
    "materials.diffuse",
    "materials.specular",
    "materials.emission",
    "materials.absorption",
    "materials.roughness",
    "materials.spec_exp",
    "materials.diff_avg",
    "materials.spec_avg",
    "materials.refr_avg",
    "materials.ior",
    "al_power",
    "pl_power",
    "pl_pos",
    "sph_center",
    "sph_radius",
    "textures",   # texel values (color/normal maps) — inverse texture
                  # painting, by autodiff through the bilinear gather
)

# Engines make_loss can differentiate. The fused kernel
# (ops/pallas/megakernel.py) renders forward only.
TRAINING_ENGINES = ("jnp", "lighttrace", "bidir")


def _is_vec3(obj) -> bool:
    return hasattr(obj, "x") and hasattr(obj, "cross")


def get_field(scene: Scene, name: str):
    obj = scene
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj.to_array() if _is_vec3(obj) else obj


def with_field(scene: Scene, name: str, value) -> Scene:
    parts = name.split(".")

    def rebuild(obj, parts, value):
        if len(parts) == 1:
            cur = getattr(obj, parts[0])
            if _is_vec3(cur):
                from ..ops.vec import Vec3
                value = Vec3.from_array(value)
            return dataclasses.replace(obj, **{parts[0]: value})
        child = rebuild(getattr(obj, parts[0]), parts[1:], value)
        return dataclasses.replace(obj, **{parts[0]: child})

    return rebuild(scene, parts, value)


def extract_params(scene: Scene, names: Iterable[str]) -> Dict[str, jax.Array]:
    return {n: get_field(scene, n) for n in names}


def merge_params(scene: Scene, params: Dict[str, jax.Array]) -> Scene:
    for n, v in params.items():
        scene = with_field(scene, n, v)
    return scene


def check_engine_fields(engine: str, field_names) -> None:
    """Raise early if the chosen engine cannot differentiate a field —
    a silent zero gradient is the failure mode this guards against."""
    if engine not in TRAINING_ENGINES:
        raise ValueError(
            f"engine={engine!r} has no gradient: the fused kernel renders "
            f"forward only; train with one of {TRAINING_ENGINES}")
    if engine == "lighttrace":
        # light-path transport never consults the reference-parity light
        # fields (emission IS materials.emission; point lights don't exist
        # in the adjoint estimator), so their gradients would be silent
        # zeros — the exact failure mode this guard exists for
        bad = [f for f in field_names
               if f in ("al_power", "pl_power", "pl_pos")]
        if bad:
            raise ValueError(
                f"engine='lighttrace' has no gradient for {bad}: light "
                "paths emit materials.emission and ignore point lights — "
                "optimize 'materials.emission' (or use engine='jnp')")
    if engine == "bidir":
        # the combined estimator is physical on both halves: area lights
        # emit their MATERIAL emission, so the legacy al_power scale is
        # never consulted (structurally zero gradient). Point lights DO
        # carry gradients — they live entirely in the forward half, which
        # keeps them at weight 1 (no light-path family competes).
        bad = [f for f in field_names if f == "al_power"]
        if bad:
            raise ValueError(
                "engine='bidir' has no gradient for ['al_power']: the "
                "physical estimator emits materials.emission — optimize "
                "'materials.emission' instead")


def make_loss(scene: Scene, cam_params, target, width: int, height: int,
              spp: int, max_bounces: int = 8, engine: str = "jnp",
              accel: str = "none", field_names=None,
              physical: bool = False) -> Callable:
    """Returns ``loss(params, seed)`` — MSE between the rendered radiance
    image and ``target``. Passing the RNG seed as an argument keeps one
    jitted loss for both fixed-stream (deterministic) and resampled
    (stochastic) optimization.

    ``engine``: "jnp" (full autodiff of the forward estimator, compiled
    by XLA), "lighttrace" (light paths only; caustic losses over light
    fields), or "bidir" (the MIS-weighted combination of forward + light
    halves — the best-conditioned gradients for caustic-driven losses WITH
    full camera-side coverage; requires ``physical=True``).

    ``accel="grid"`` builds the uniform grid (ops/grid.py) ONCE from the
    initial scene and uses it in every loss evaluation. Valid while the
    optimized fields leave geometry fixed; optimizing sphere/triangle
    positions across cell boundaries requires rebuilding the grid between
    steps.

    ``physical=True`` optimizes against the unbiased estimator instead of
    the reference-parity one (gradients of real-world capture losses should
    not chase the parity quirks). The MIS weights are grad-safe by
    construction (clamped denominators, detached branch choices);
    FD-validated in tests/test_gradients.py.
    """
    if engine not in TRAINING_ENGINES:
        check_engine_fields(engine, ())   # raises: no gradient path
    grid = None
    if accel == "grid":
        if engine in ("lighttrace", "bidir"):
            raise ValueError(f"engine='{engine}' does not take accel='grid'"
                             " (the adjoint tracer uses the linear sweeps)")
        from ..ops.grid import build_grid
        grid = build_grid(scene)
    if engine == "lighttrace":
        if not physical:
            raise ValueError(
                "engine='lighttrace' estimates the PHYSICAL integral "
                "(light paths have no reference-parity analog); pass "
                "physical=True so the target provenance matches — a "
                "parity-estimator target would give the loss a silent "
                "systematic floor")
        # Train THROUGH the splats: the scatter-add's VJP is a gather, so
        # every continuous factor of a splat (emission, albedos, falloff,
        # cosines) carries gradient; splat PIXEL indices are discrete and
        # detached, so — like the forward interior gradient — visibility
        # boundaries are not differentiated (render/silhouette.py is the
        # boundary story). Caustic-driven losses are the use case: light
        # emission/materials train through paths eye sampling rarely finds.
        from .lighttrace import render_lighttrace
        n_paths = spp * width * height  # effort comparable to spp eye passes

        def loss(params, seed):
            s = merge_params(scene, params)
            img = render_lighttrace(s, cam_params, width, height, n_paths,
                                    seed, max_bounces=max_bounces)
            return jnp.mean((img - target) ** 2)

        return loss
    if engine == "bidir":
        # round 5 (VERDICT r4 ask #2): TRAIN through the combined
        # MIS-weighted estimator. Both halves are pure JAX (the forward
        # physical tracer with the bidir MIS carries + the light tracer's
        # differentiable splats), so jax.grad flows through the whole
        # combination: caustic-driven losses get the light half's sharp
        # gradients exactly where forward sampling is noisiest, while
        # camera-visible glass keeps the forward half's. Discrete
        # decisions (hits, branch picks, splat pixels) are detached as
        # everywhere else; MIS weights are grad-safe (clamped ratio sums).
        if not physical:
            raise ValueError(
                "engine='bidir' estimates the PHYSICAL integral (the MIS "
                "weights assume the unbiased densities); pass "
                "physical=True so the target provenance matches")
        from .bidir import render_bidir
        n_paths = spp * width * height  # same effort convention as lighttrace

        def loss(params, seed):
            s = merge_params(scene, params)
            img = render_bidir(s, cam_params, width, height, spp, n_paths,
                               seed, max_bounces=max_bounces)
            return jnp.mean((img - target) ** 2)

        return loss
    def loss(params, seed):
        s = merge_params(scene, params)
        img = render(s, cam_params, width, height, spp, seed,
                     max_bounces=max_bounces, live_cutoff=None, grid=grid,
                     physical=physical)
        return jnp.mean((img - target) ** 2)

    return loss


def directional_fd_check(loss: Callable, params: Dict[str, jax.Array],
                         seed, eps: float = 2e-3, num_directions: int = 3
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Compare <grad, v> against central differences along random unit
    directions v, with the SAME render streams on both sides. Returns
    (ad, fd) arrays of shape [num_directions]."""
    render_seed = jnp.asarray(seed, jnp.int32)
    dir_key = jax.random.PRNGKey(seed)  # direction draws only, not renders
    grad = jax.grad(loss)(params, render_seed)
    ad, fd = [], []
    flat_g, treedef = jax.tree_util.tree_flatten(grad)
    flat_p = treedef.flatten_up_to(params)
    for i in range(num_directions):
        ks = jax.random.split(jax.random.fold_in(dir_key, i), len(flat_p))
        vs = [jax.random.normal(k, p.shape, jnp.float32) for k, p in zip(ks, flat_p)]
        norm = jnp.sqrt(sum(jnp.sum(v * v) for v in vs))
        vs = [v / norm for v in vs]
        plus = treedef.unflatten([p + eps * v for p, v in zip(flat_p, vs)])
        minus = treedef.unflatten([p - eps * v for p, v in zip(flat_p, vs)])
        fd.append((loss(plus, render_seed) - loss(minus, render_seed)) / (2 * eps))
        ad.append(sum(jnp.sum(g * v) for g, v in zip(flat_g, vs)))
    return np.asarray(jax.device_get(ad)), np.asarray(jax.device_get(fd))


def invert(scene_init: Scene, cam_params, target, field_names: Iterable[str],
           width: int, height: int, spp: int = 4, steps: int = 200,
           lr: float = 5e-2, seed: int = 0,
           max_bounces: int = DEFAULT_MAX_BOUNCES,
           resample_every: int = 0, callback=None, engine: str = "jnp",
           accel: str = "none", physical: bool = False,
           silhouette: bool = False):
    """Inverse rendering: gradient-descend the named scene fields toward a
    target image (BASELINE config 4). ``resample_every=k`` folds a new RNG
    key every k steps (stochastic gradients over sample noise); 0 keeps one
    fixed stream (deterministic loss surface). ``engine`` is one of
    TRAINING_ENGINES (checked). ``accel="grid"`` is valid when no geometry field is optimized (the grid
    is built once from the initial scene — see make_loss).
    ``silhouette=True`` adds the edge-sampled visibility-boundary term to
    geometry gradients (render/silhouette.py) — without it AD is
    interior-only and silhouette motion is invisible to the loss. It runs
    on the jnp engine."""
    field_names = tuple(field_names)
    check_engine_fields(engine, field_names)
    if silhouette and engine in ("lighttrace", "bidir"):
        raise ValueError(
            f"silhouette=True supports engine='jnp' only: the "
            f"boundary term's jump integrand is the forward estimator's — "
            f"mixing it with the '{engine}' interior gradient would blend "
            "two different integrands' boundary weights (use engine='jnp' "
            "with physical=True for boundary-aware physical training)")
    if silhouette and accel == "grid":
        raise ValueError("silhouette=True moves geometry; accel='grid' "
                         "would go stale (same rule as geometry fields)")
    if accel == "grid":
        geom = [f for f in field_names
                if f.startswith(("sph_", "tri_")) or "center" in f
                or "radius" in f]
        if geom:
            raise ValueError(f"accel='grid' with geometry fields {geom}: the "
                             "cell lists would go stale; use accel='none'")
    params = extract_params(scene_init, field_names)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)
    loss = make_loss(scene_init, cam_params, target, width, height, spp,
                     max_bounces, engine=engine, accel=accel,
                     field_names=field_names, physical=physical)
    if silhouette:
        from .silhouette import make_grad_with_boundary
        vg = make_grad_with_boundary(scene_init, cam_params, target,
                                     field_names, width, height, spp,
                                     max_bounces=max_bounces,
                                     physical=physical, engine=engine)
    else:
        vg = jax.jit(jax.value_and_grad(loss))

    @jax.jit
    def apply(params, opt_state, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def update(params, opt_state, s):
        val, grads = vg(params, s)
        params, opt_state = apply(params, opt_state, grads)
        return params, opt_state, val

    losses = []
    base = jnp.asarray(seed, jnp.int32)
    for step in range(steps):
        s = (rng.seed_for(base, step // resample_every)
             if resample_every else base)
        params, opt_state, val = update(params, opt_state, s)
        losses.append(float(val))
        if callback:
            callback(step, float(val), params)
    return merge_params(scene_init, params), params, losses
