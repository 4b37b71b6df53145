"""CLI smoke tests (jnp engine, CPU)."""
import json
import os

import numpy as np
import pytest

from cuda_path_tracer_ss.cli import main
from cuda_path_tracer_ss.utils.image import read_png


def test_render_writes_png_and_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "r.png")
    ck = str(tmp_path / "ck.npz")
    main(["render", "--scene", "cornell_empty", "--width", "16", "--height",
          "16", "--spp", "2", "--bounces", "2", "--samples-per-pass", "2",
          "--engine", "jnp", "--out", out, "--checkpoint", ck])
    assert os.path.exists(out) and os.path.exists(ck)
    img = read_png(out)
    assert img.shape == (16, 16, 3)
    assert img.max() > 0


def test_render_resume_continues(tmp_path):
    out1 = str(tmp_path / "a.png")
    ck = str(tmp_path / "ck.npz")
    main(["render", "--scene", "cornell_empty", "--width", "16", "--height",
          "16", "--spp", "2", "--bounces", "2", "--samples-per-pass", "2",
          "--engine", "jnp", "--out", out1, "--checkpoint", ck])
    out2 = str(tmp_path / "b.png")
    main(["render", "--scene", "cornell_empty", "--width", "16", "--height",
          "16", "--spp", "4", "--bounces", "2", "--samples-per-pass", "2",
          "--engine", "jnp", "--out", out2, "--resume", ck])
    assert os.path.exists(out2)


def test_benchmark_outputs_json(capsys):
    main(["benchmark", "--scene", "cornell_empty", "--width", "16",
          "--height", "16", "--spp", "1", "--bounces", "2", "--repeats", "1",
          "--engine", "jnp"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    data = json.loads(line)
    assert data["engine"] == "jnp"
    assert data["primary_rays_per_s"] > 0


@pytest.mark.slow
def test_grad_check_allclose(capsys):
    main(["grad-check", "--scene", "cornell_lambert", "--width", "12",
          "--height", "12", "--spp", "1", "--bounces", "2",
          "--fields", "materials.diffuse", "--engine", "jnp"])
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert data["allclose"] is True, data


def test_unknown_scene_raises():
    with pytest.raises(KeyError, match="unknown scene preset"):
        main(["render", "--scene", "nope", "--width", "8", "--height", "8",
              "--engine", "jnp"])


def test_interact_drives_via_stdin(tmp_path, monkeypatch, capsys):
    # scripted session: render a pass, move camera (reset), toggle ray-trace
    # mode, screenshot, quit
    import io
    import cuda_path_tracer_ss.cli as cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("w\np\n0\nx\n"))
    out = str(tmp_path / "final.png")
    main(["interact", "--scene", "cornell_empty", "--width", "8", "--height",
          "8", "--spp", "2", "--bounces", "2", "--samples-per-pass", "1",
          "--engine", "jnp", "--out", out])
    text = capsys.readouterr().out
    assert "camera moved (w)" in text
    assert "ray-trace mode" in text
    assert "wrote" in text
    assert os.path.exists(out)


def test_failure_kill_resume_bit_identical(tmp_path):
    """Failure-path recovery (SURVEY §5 'snapshot-as-restart-point'): a
    worker SIGKILLed mid-render is relaunched from its periodic checkpoint
    (--checkpoint-every) by a supervisor loop and finishes with the SAME
    accumulator, bit for bit, as an uninterrupted run — counter-based RNG
    keys samples globally, so restart position doesn't change any stream."""
    import signal
    import subprocess
    import sys as _sys
    import time as _time

    ck = str(tmp_path / "ck.npz")
    out = str(tmp_path / "killed.npy")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CPT_GPU_TESTS="")
    argv = [_sys.executable, "-m", "cuda_path_tracer_ss.cli", "render",
            "--scene", "cornell_empty", "--width", "16", "--height", "16",
            "--spp", "6", "--bounces", "2", "--samples-per-pass", "1",
            "--engine", "jnp", "--out", out, "--checkpoint", ck,
            "--checkpoint-every", "1"]

    # run 1: kill -9 as soon as the first periodic snapshot lands
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = _time.time() + 300
    while not os.path.exists(ck) and _time.time() < deadline:
        if proc.poll() is not None:
            break  # finished before we could kill it — still a valid run
        _time.sleep(0.05)
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        assert proc.returncode != 0  # really died
    # supervisor: relaunch with --resume until the worker exits cleanly
    for _ in range(6):
        if subprocess.run(argv + ["--resume", ck], env=env,
                          stdout=subprocess.DEVNULL).returncode == 0:
            break
    else:
        raise AssertionError("worker never completed")

    # uninterrupted run in this process for the ground-truth accumulator
    from cuda_path_tracer_ss.models.camera import Camera
    from cuda_path_tracer_ss.models.presets import get_scene
    from cuda_path_tracer_ss.render.renderer import (
        ProgressiveRenderer, RenderConfig)
    r = ProgressiveRenderer(get_scene("cornell_empty"), Camera(),
                            RenderConfig(width=16, height=16, spp=6,
                                         samples_per_pass=1, max_bounces=2,
                                         engine="jnp"))
    r.run()
    got = np.load(out)
    np.testing.assert_array_equal(got, np.asarray(r.radiance()))


def test_render_user_obj_with_mtl(tmp_path, capsys):
    """--obj FILE: a user OBJ + its mtllib render inside the Cornell shell
    with the .mtl-derived materials (the 'bring your own mesh' flow)."""
    (tmp_path / "demo.mtl").write_text(
        "newmtl glow\nKe 3 2 1\nnewmtl body\nKd 0.2 0.4 0.8\n")
    (tmp_path / "demo.obj").write_text(
        "mtllib demo.mtl\nv -1 0 0\nv 1 0 0\nv 0 1.5 0\nv 0 0.4 1\n"
        "usemtl body\nf 1 2 3\nusemtl glow\nf 1 2 4\n")
    out = str(tmp_path / "obj.png")
    main(["render", "--obj", str(tmp_path / "demo.obj"), "--width", "16",
          "--height", "16", "--spp", "2", "--bounces", "2",
          "--samples-per-pass", "2", "--engine", "jnp", "--out", out])
    assert "materials: ['body', 'glow']" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (16, 16, 3) and img.max() > 0
