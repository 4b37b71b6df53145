"""chip_smoke.py's multi-card phase (``--devices 4`` on the card),
rehearsed on the CPU's virtual devices at a tiny size with the kernel in
interpret mode: the same meshes, sharding rules and comparisons."""
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_multi_card_phase_on_virtual_devices():
    import chip_smoke

    assert len(jax.devices()) >= 4
    chip_smoke.FAILED.clear()
    chip_smoke.four_cards("virtual CPU devices", size=64, interpret=True)
    assert chip_smoke.FAILED == []
