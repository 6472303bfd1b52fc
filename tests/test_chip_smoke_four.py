"""CPU rehearsal of chip_smoke.py --four-cards on four of the virtual CPU
devices, tiny worlds."""

import jax

import chip_smoke as cs
from tests.test_chip_smoke import CHUNK, WORLD, log, tiny_config


def test_four_card_paths():
    cfg = tiny_config(local_ba_window=4, local_ba_every=2)
    streams = [cs.render(("stereo", dict(WORLD, seed=201 + k), 2 * CHUNK,
                          0.3 + 0.02 * k, None, False)) for k in range(4)]
    shard_frames = cs.render(("stereo", WORLD, 4, 0.3, None, True))
    cs.run_four_cards(log, jax.devices()[:4], cfg, streams, CHUNK,
                      shard_frames, streams[:2], cfg,
                      peak_bytes=lambda d: 1)
