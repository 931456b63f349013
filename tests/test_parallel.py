"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Exercises the same shard_map/ppermute code paths that run across GPUs
(SURVEY.md section 4 item (3)): channel parallelism (BASELINE config
3) and time-block sharding with halo exchange (BASELINE config 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liquiddsp_tpu.core.config import FrameConfig
from liquiddsp_tpu.parallel.halo import shard_stream, sharded_framesync
from liquiddsp_tpu.parallel.mesh import CH_AXIS, TIME_AXIS, channel_sharding, make_mesh
from liquiddsp_tpu.phy import frame_spec as fs, framegen
from liquiddsp_tpu.phy.framesync import framesync_fixed

QPSK_CFG = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)


@pytest.fixture(scope="module")
def devices8():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jax.devices()


class TestMesh:
    def test_mesh_shapes(self, devices8):
        m = make_mesh()
        assert m.shape[TIME_AXIS] == 8 and m.shape[CH_AXIS] == 1
        m2 = make_mesh(n_time=4, n_ch=2)
        assert m2.shape[TIME_AXIS] == 4 and m2.shape[CH_AXIS] == 2


class TestChannelParallel:
    def test_64_channels_sharded(self, devices8):
        """BASELINE config 3 miniature: independent channels over the ch
        axis; results identical to unsharded execution."""
        mesh = make_mesh(n_time=1, n_ch=8)
        rng = np.random.default_rng(0)
        payloads = rng.integers(0, 256, (8, 64), dtype=np.uint8)
        frames = np.asarray(framegen.framegen(jnp.asarray(payloads), QPSK_CFG))
        t = 4096
        x = np.zeros((8, t), dtype=np.complex64)
        offs = rng.integers(0, t - frames.shape[1], size=8)
        for b in range(8):
            x[b, offs[b] : offs[b] + frames.shape[1]] = frames[b]
        xs = jax.device_put(jnp.asarray(x), channel_sharding(mesh))
        res = jax.jit(
            lambda a: framesync_fixed(a, QPSK_CFG, max_frames=2)
        )(xs)
        mask = np.asarray(res.mask)
        pv = np.asarray(res.payload_valid)
        assert mask.any(axis=1).all()
        for b in range(8):
            k = int(np.argmax(mask[b]))
            assert pv[b, k]
            np.testing.assert_array_equal(np.asarray(res.payload)[b, k], payloads[b])


class TestTimeSharding:
    def test_halo_exchange_boundary_frames(self, devices8):
        """Frames straddling shard boundaries are recovered exactly once via
        the ppermute halo."""
        mesh = make_mesh(n_time=8, n_ch=1)
        spec = fs.FrameSpec(QPSK_CFG)
        t_local = 4096
        t = 8 * t_local
        rng = np.random.default_rng(1)
        payloads = rng.integers(0, 256, (4, 64), dtype=np.uint8)
        frames = np.asarray(framegen.framegen(jnp.asarray(payloads), QPSK_CFG))
        f = frames.shape[1]
        # straddle three shard boundaries + one frame mid-shard
        starts = [t_local - f // 2, 3 * t_local - f + 20, 5 * t_local - 10, 6 * t_local + 500]
        x = np.zeros((1, t), dtype=np.complex64)
        for s, fr in zip(starts, frames):
            x[0, s : s + f] = fr
        xs = shard_stream(jnp.asarray(x), mesh)
        res = jax.jit(
            lambda a: sharded_framesync(a, QPSK_CFG, mesh, max_frames_per_shard=4)
        )(xs)
        mask = np.asarray(res.mask)[0]
        got = []
        for k in np.nonzero(mask)[0]:
            got.append(
                (int(np.asarray(res.start)[0, k]), bytes(np.asarray(res.payload)[0, k]),
                 bool(np.asarray(res.payload_valid)[0, k]))
            )
        assert len(got) == 4, got
        got.sort()
        for (s_got, p_got, v), s_want, p_want in zip(got, starts, payloads):
            assert abs(s_got - s_want) <= 1
            assert v
            assert p_got == bytes(p_want)

    @pytest.mark.parametrize(
        "cfg",
        [
            QPSK_CFG,                      # plain coherent
            FrameConfig(1, 1, 1, 64),      # concatenated Viterbi+Golay
            FrameConfig(5, 0, 0, 64),      # differential DQPSK
            FrameConfig(10, 0, 2, 64),     # dense QAM64 + RS outer
        ],
        ids=["qpsk", "qpsk_v27_golay", "dqpsk", "qam64_rs"],
    )
    def test_matches_unsharded(self, devices8, cfg):
        """Sharded and single-device RX agree on payloads — across config
        CLASSES (the FEC kernels, differential demod and
        dense-QAM decode must all survive the halo path, not just QPSK)."""
        f = framegen.frame_length(cfg)
        t_local = max(2048, ((2 * f + 800) // 256) * 256)
        mesh = make_mesh(n_time=8, n_ch=1)
        rng = np.random.default_rng(2)
        payloads = rng.integers(0, 256, (2, 64), dtype=np.uint8)
        frames = np.asarray(framegen.framegen(jnp.asarray(payloads), cfg))
        t = 8 * t_local
        x = np.zeros((1, t), dtype=np.complex64)
        # one interior frame + one straddling a shard boundary
        x[0, 300 : 300 + f] = frames[0]
        s2 = 4 * t_local - f // 2
        x[0, s2 : s2 + f] = frames[1]
        ref = framesync_fixed(jnp.asarray(x), cfg, max_frames=8)
        xs = shard_stream(jnp.asarray(x), mesh)
        res = sharded_framesync(xs, cfg, mesh, max_frames_per_shard=4)

        def collect(r):
            m = np.asarray(r.mask)[0]
            return sorted(
                (int(np.asarray(r.start)[0, k]), bytes(np.asarray(r.payload)[0, k]))
                for k in np.nonzero(m)[0]
            )

        assert collect(ref) == collect(res)
