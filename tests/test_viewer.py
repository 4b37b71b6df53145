"""Automated drive of the browser viewer (GL-window replacement): serve,
fetch a frame, press a key, observe the accumulation reset."""
import json
import threading
import time
import urllib.request

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render.renderer import ProgressiveRenderer, RenderConfig
from cuda_path_tracer_ss.viewer import serve


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def test_viewer_serves_frames_and_handles_keys():
    # passes must be slow enough (~0.5s) that the post-reset spp counter is
    # observably below the pre-key value between 0.1s polls
    cfg = RenderConfig(width=96, height=96, max_bounces=4,
                       spp=10 ** 9, samples_per_pass=8, engine="jnp")
    renderer = ProgressiveRenderer(presets.cornell_empty(), Camera(), cfg)

    port = 8765
    state_holder = {}

    def run_server():
        serve(renderer, port=port, state_out=state_holder)

    t = threading.Thread(target=run_server, daemon=True)
    t.start()

    try:
        # wait for the page + a first rendered frame
        deadline = time.time() + 60
        page = b""
        while time.time() < deadline:
            try:
                page = _get(port, "/")
                stats = json.loads(_get(port, "/stats"))
                if stats["spp"] >= 1:
                    break
            except Exception:
                pass
            time.sleep(0.5)
        assert b"progressive view" in page
        assert stats["spp"] >= 1

        frame = _get(port, "/frame.png")
        assert frame[:8] == b"\x89PNG\r\n\x1a\n"

        # let a few passes accumulate so the reset is unambiguous
        deadline = time.time() + 60
        while time.time() < deadline:
            spp_before = json.loads(_get(port, "/stats"))["spp"]
            if spp_before >= 24:
                break
            time.sleep(0.2)
        # camera key -> accumulation reset observable through /stats
        assert _get(port, "/key?k=w") == b"ok"
        deadline = time.time() + 60
        reset_seen = False
        while time.time() < deadline:
            spp_now = json.loads(_get(port, "/stats"))["spp"]
            if spp_now < spp_before:
                reset_seen = True
                break
            time.sleep(0.1)
        assert reset_seen, "camera move did not reset accumulation"
    finally:
        # clean shutdown: the render loop checks state.stop each iteration
        if "state" in state_holder:
            state_holder["state"].stop = True
        t.join(timeout=30)
        assert not t.is_alive(), "viewer render loop did not stop"
