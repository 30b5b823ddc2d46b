"""The augmentation package of the PyTorch port on the CPU, against the JAX
package's augment/ with JAX's raw draws injected.

  * `nearest_index`: JAX's nearest resize index (not torch's "nearest") at
    the masks' real sizes, 6 or 81 cells onto 90 x 360 frames;
  * each op of the pipeline on a (2, 4, H, W, 3) stack, one key per sample
    shared by its 4 frames (the learner's vmap), the jitter ops at the
    strengths of alpha 1.0 and 0.5, the two masks at 90 x 360;
  * `carla_augment_pipeline` against
    jax.vmap(jax.vmap(carla_augment_pipeline, (None, 0, None)), (0, 0, None))
    at alpha 1.0 and 0.5, the draws rebuilt from the samples' keys as
    simclr.py splits them (`jax_pipeline_draws`), the samples' keys picked
    so that every gated branch is taken and skipped (the jitter's gate is
    always taken at alpha 1.0); alpha 0 is the identity and draws nothing;
  * `CARLAgent.gather_batch` with aug_intensity > 0 against JAX's
    planes -> [0, 1] -> pipeline on the same planes and draws; with
    aug_intensity 0 the generator is untouched;
  * the ops off the pipeline's path, each against JAX.

Tolerance: 1e-5 absolute on [0, 1] images (float32 sums and
convolutions in another order; observed <= 3e-6); the selection masks
(salt and pepper, the noise's pixels, cutout, coarse dropout, the gates)
exact.  A frame that enters flat (a stack's zero frame) and meets no
blur, salt or noise leaves the jitter flat up to float32 rounding, which
normalize divides by its eps of 1e-7: no two implementations agree there
(JAX 0.149 against the port's 0.298 on one such frame), so such frames
are held before normalize to 1e-5 and after it to [0, 1].
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.augment import augmentations as JA
from carla_driving_rl_agent_tpu.augment import simclr as JS
from carla_driving_rl_agent_tpu.envs.carla_env import planes_to_image as jplanes_to_image

from carla_driving_rl_agent_torch.agents import rollout as trollout
from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.augment import augmentations as A
from carla_driving_rl_agent_torch.augment import simclr as S

from test_torch_curriculum import one_thread  # noqa: F401

ATOL = 1e-5
MB, T = 2, 4
H, W, C = 18, 40, 3            # the ops' small frames
MASK_H, MASK_W = 90, 360       # the learner's frames: 90 x 3 * 120


def _stack(h=H, w=W, seed=0):
    return np.random.default_rng(seed).random((MB, T, h, w, C), dtype=np.float32)


def _keys(n=MB, seed=1):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _per_sample(jfn):
    """A JAX op of (key, frame) over (samples, frames): one key per sample,
    shared by its frames, as the JAX learner vmaps the pipeline."""
    return jax.jit(jax.vmap(jax.vmap(jfn, (None, 0)), (0, 0)))


def _close(got, want, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _u(shape=()):
    return jax.jit(jax.vmap(lambda k: jax.random.uniform(k, shape)))


def _n(shape):
    return jax.jit(jax.vmap(lambda k: jax.random.normal(k, shape)))


def _split2(draw1, draw2):
    """The draws of an op that splits its key in two."""
    return jax.jit(jax.vmap(lambda k: tuple(f(kk) for f, kk in zip((draw1, draw2),
                                                                   jax.random.split(k)))))


# ---------------------------------------------------------------- nearest resize

@pytest.mark.parametrize("n_in,n_out", [(6, MASK_H), (6, MASK_W), (81, MASK_H), (81, MASK_W)])
def test_nearest_index_matches_jax(n_in, n_out):
    ramp = jnp.arange(n_in, dtype=jnp.float32)[:, None] * jnp.ones((1, 2), jnp.float32)
    want = np.asarray(jax.image.resize(ramp, (n_out, 2), "nearest"))[:, 0].astype(np.int64)
    np.testing.assert_array_equal(A.nearest_index(n_in, n_out).numpy(), want)
    grid = torch.arange(n_in * n_in, dtype=torch.float32).reshape(n_in, n_in)
    jgrid = jnp.asarray(grid.numpy())
    np.testing.assert_array_equal(A.resize_nearest(grid, (n_out, n_out)).numpy(),
                                  np.asarray(jax.image.resize(jgrid, (n_out, n_out), "nearest")))


# ---------------------------------------------------------------- the pipeline's ops

# color_jitter's ranges at strength s
JITTER_RANGES = dict(brightness=lambda s: dict(delta=0.2 * s),
                     contrast=lambda s: dict(lower=1.0 - 0.8 * s, upper=1.0 + 0.8 * s),
                     saturation=lambda s: dict(lower=1.0 - 0.8 * s, upper=1.0 + 0.8 * s),
                     hue=lambda s: dict(delta=0.2 * s))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("name", sorted(JITTER_RANGES))
def test_jitter_op_matches_jax(name, alpha):
    """Each op of color_jitter at alpha's strength, its uniform per sample
    scaled inside the op; contrast's mean and the gray image per frame."""
    img, keys = _stack(), _keys()
    kw = JITTER_RANGES[name](alpha)
    want = _per_sample(lambda k, x: getattr(JA, name)(k, x, **kw))(keys, img)
    _close(getattr(A, name)(_t(img), _t(_u()(keys)), **kw), want)
    assert float(np.abs(np.asarray(want) - img).max()) > 1e-3, "the op did nothing"


@pytest.mark.parametrize("size", [3, 5])
def test_gaussian_blur_matches_jax(size):
    """The random near-one kernel per sample, applied as a
    cross-correlation with SAME zero padding (an asymmetric kernel: a
    convolution would differ)."""
    img, keys = _stack(), _keys()
    want = _per_sample(lambda k, x: JA.gaussian_blur(k, x, size=size))(keys, img)
    got = A.gaussian_blur(_t(img), _t(_n((size, size))(keys)))
    _close(got, want)
    flipped = A.gaussian_blur(_t(img), _t(_n((size, size))(keys)).flip(-1, -2))
    assert float((flipped - got).abs().max()) > 10 * ATOL


def test_salt_and_pepper_matches_jax():
    img, keys = _stack(), _keys(seed=4)
    want = _per_sample(lambda k, x: JA.salt_and_pepper(k, x, amount=0.1))(keys, img)
    sel, val = _split2(lambda k: jax.random.uniform(k, (H, W)),
                       lambda k: jax.random.uniform(k, (H, W)))(keys)
    got = A.salt_and_pepper(_t(img), _t(sel), _t(val), amount=0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got != _t(img)).any()), "no pixel selected"


def test_gaussian_noise_matches_jax():
    """Noise on the pixels where select < amount, only its positive part."""
    img, keys = _stack(), _keys()
    want = np.asarray(_per_sample(
        lambda k, x: JA.gaussian_noise(k, x, amount=0.10, std=0.075))(keys, img))
    sel, noise = _split2(lambda k: jax.random.uniform(k, (H, W)),
                         lambda k: jax.random.normal(k, (H, W, C)))(keys)
    got = A.gaussian_noise(_t(img), _t(sel), _t(noise), amount=0.10, std=0.075)
    _close(got, want)
    np.testing.assert_array_equal(got.numpy() > img, want > img)
    assert bool((got.numpy() > img).any())


def test_normalize_matches_jax():
    """The min-max of each frame, not of the stack."""
    img = _stack() * np.linspace(0.2, 1.0, T, dtype=np.float32)[:, None, None, None]
    want = jax.vmap(jax.vmap(JA.normalize))(img)
    _close(A.normalize(_t(img)), want)


@pytest.mark.parametrize("op", ["cutout", "coarse_dropout"])
def test_masks_match_jax_at_the_real_size(op):
    """The 6 x 6 argmax cell and the 81 x 81 grid, resized nearest onto 90 x
    360 frames with JAX's index: exact."""
    img, keys = _stack(MASK_H, MASK_W), _keys(seed=2)
    if op == "cutout":
        want = _per_sample(lambda k, x: JA.cutout(k, x, size=6))(keys, img)
        got = A.cutout(_t(img), _t(_n((6, 6))(keys)))
    else:
        want = _per_sample(lambda k, x: JA.coarse_dropout(k, x, size=81, amount=0.04))(keys, img)
        got = A.coarse_dropout(_t(img), _t(_u((81, 81))(keys)), amount=0.04)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got == 0).any())


# ---------------------------------------------------------------- the whole pipeline

N, PH, PW = 8, 24, 96          # samples, frames of the pipeline and gather tests
ILL_RANGE = 1e-2               # a range before normalize below which it amplifies
                               # the implementations' rounding (~1e-7) beyond ATOL
jax_pipeline = jax.jit(jax.vmap(jax.vmap(JS.carla_augment_pipeline, (None, 0, None)),
                                (0, 0, None)), static_argnums=2)


def jax_pipeline_draws(key, h, w, c) -> tuple:
    """The raw draws JAX's carla_augment_pipeline makes from `key`, in the
    order of PipelineDraws: split(key, 12) as simclr.py:50 and color
    jitter's split(keys[1], 4) as :19; blur3 and blur5 both from keys[3],
    cutout and coarse dropout both from keys[10]; salt and pepper's and the
    noise's split(keys[6]) and split(keys[8])."""
    keys = jax.random.split(key, 12)
    u = jax.random.uniform
    sp, nz = jax.random.split(keys[6]), jax.random.split(keys[8])
    return (jnp.stack([u(keys[i], ()) for i in (0, 2, 4, 5, 7, 9, 11)]),
            jnp.stack([u(k, ()) for k in jax.random.split(keys[1], 4)]),
            jax.random.normal(keys[3], (3, 3)), jax.random.normal(keys[3], (5, 5)),
            u(sp[0], (h, w)), u(sp[1], (h, w)), u(nz[0], (h, w)),
            jax.random.normal(nz[1], (h, w, c)),
            jax.random.normal(keys[10], (S.CUTOUT_GRID, S.CUTOUT_GRID)),
            u(keys[10], (S.COARSE_GRID, S.COARSE_GRID)))


def _draws_of(keys, h=PH, w=PW, c=C) -> S.PipelineDraws:
    d = jax.jit(jax.vmap(lambda k: jax_pipeline_draws(k, h, w, c)))(keys)
    return S.PipelineDraws(*(_t(x) for x in d))


def _branches(gate: np.ndarray, alpha: float) -> dict:
    """Per sample, whether each gated branch is taken."""
    g = dict(zip(S.GATES, gate.T))
    blur = g["blur"] < np.float32(0.25 * alpha)
    return dict(jitter=g["jitter"] < np.float32(alpha), blur3=blur & (g["blur_size"] >= 0.5),
                blur5=blur & (g["blur_size"] < 0.5),
                salt_and_pepper=g["salt_and_pepper"] < np.float32(0.2 * alpha),
                noise=g["noise"] < np.float32(0.33 * alpha),
                cutout=g["cutout"] < np.float32(0.15 * alpha),
                coarse_dropout=g["coarse_dropout"] < np.float32(0.15 * alpha))


@pytest.fixture(scope="module")
def covering():
    """N samples' keys among which every gated branch is taken and skipped
    at alpha 1.0 and at 0.5 (the jitter's gate is always taken at 1.0),
    and their draws: for each branch, alpha and outcome not yet covered,
    the first candidate key that covers it, then the next candidates up
    to N."""
    keys = _keys(256, seed=7)
    gate = np.asarray(jax.jit(jax.vmap(lambda k: jax_pipeline_draws(k, 1, 1, 1)[0]))(keys))
    picked = []
    for alpha in (1.0, 0.5):
        for t in _branches(gate, alpha).values():
            for outcome in (True, False):
                if not any(t[i] == outcome for i in picked) and (t == outcome).any():
                    picked.append(int(np.argmax(t == outcome)))
    picked = sorted(set(picked))
    assert len(picked) <= N
    picked += [i for i in range(256) if i not in picked][:N - len(picked)]
    keys = keys[np.asarray(picked)]
    return keys, _draws_of(keys)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_pipeline_matches_jax(covering, alpha):
    keys, d = covering
    for name, t in _branches(d.gate.numpy(), alpha).items():
        assert t.any(), f"{name} never taken"
        assert not t.all() or (name == "jitter" and alpha >= 1.0), f"{name} never skipped"
    img = np.random.default_rng(3).random((N, T, PH, PW, C), dtype=np.float32)
    _close(S.carla_augment_pipeline(_t(img), d, alpha), jax_pipeline(keys, img, alpha))


def test_alpha_zero_is_the_identity_and_draws_nothing():
    img = _t(_stack())
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    assert S.augment(gen, img, 0.0) is img
    assert torch.equal(gen.get_state(), state)
    assert S.carla_augment_pipeline(img, None, 0.0) is img
    out = S.augment(gen, img, 1.0)
    assert not torch.equal(gen.get_state(), state) and out.shape == img.shape
    want = jax.vmap(jax.vmap(JS.carla_augment_pipeline, (None, 0, None)),
                    (0, 0, None))(_keys(), np.asarray(img), 0.0)
    np.testing.assert_array_equal(img.numpy(), np.asarray(want))


# ---------------------------------------------------------------- the learner hook

STEPS, ENVS = 6, 4


def _rollout_data(seed: int = 0) -> dict:
    """What CARLAgent.targets hands gather_batch, for STEPS x ENVS samples
    of random half-resolution planes: stacks of 4 frame ids, every other
    sample's oldest 1-3 of them the zero-frame sentinel (< -T) of an
    episode that started within the stack."""
    g = torch.Generator().manual_seed(seed)
    planes = lambda n: torch.randint(0, 256, (n, ENVS, C, PH // 2, PW // 2),  # noqa: E731
                                     generator=g, dtype=torch.uint8)
    traj = types.SimpleNamespace(init_stack=planes(T), frames=planes(STEPS))
    ids = torch.arange(STEPS)[:, None, None] + torch.arange(-T + 1, 1)     # (S, 1, T)
    ids = ids.expand(STEPS, ENVS, T).clone()
    zeros = torch.arange(STEPS * ENVS).reshape(STEPS, ENVS) % 6          # 0..5
    for k in range(1, 4):
        ids[..., k - 1][(zeros % 2 == 1) & (zeros >= 2 * k - 1)] = -T - 1
    traj.stack_ids = ids
    n = STEPS * ENVS
    flat = {k: torch.rand((n,) + shape, generator=g) for k, shape in dict(
        advantages=(), returns=(2,), log_prob=(2,), action=(2,), speed=(), similarity=(),
        road=(9,), vehicle=(4,), navigation=(10,)).items()}
    return dict(flat, traj=traj, step=torch.arange(STEPS).repeat_interleave(ENVS),
                env=torch.arange(ENVS).repeat(STEPS), timeline=trollout.frame_timeline(traj))


def _learner(alpha: float):
    """What gather_batch reads of its agent: the env's upsampling, the
    agent's generator and its config."""
    env = types.SimpleNamespace(config=types.SimpleNamespace(upsample=(2, 2)))
    return types.SimpleNamespace(env=env, generator=torch.Generator().manual_seed(5),
                                 config=CARLAgentConfig(aug_intensity=alpha))


def _jax_images(data, idx):
    planes = trollout.gather_image_stacks(data["traj"], data["step"][idx], data["env"][idx],
                                          data["timeline"])
    return np.asarray(jplanes_to_image(jnp.asarray(planes.numpy()), 2, 2), np.float32) / 255.0


def test_gather_batch_augments_as_jax(covering, monkeypatch):
    """CARLAgent.gather_batch at aug_intensity 1.0: the samples' stacks
    gathered, then one set of draws per sample from the agent's generator,
    shared by its 4 frames, statistics per frame; against JAX's
    planes_to_image / 255 and vmapped pipeline on the same planes, with
    the same draws.  Where normalize is ill-conditioned (a range below
    ILL_RANGE before it: only frames that entered flat, here the zero
    frames of samples that meet no blur, salt or noise), the outputs are
    held to [0, 1], and the pipeline without normalize to ATOL on every
    frame."""
    keys, d = covering
    data = _rollout_data()
    idx = torch.tensor([1, 3, 5, 7, 9, 10, 13, 16])
    learner = _learner(1.0)
    calls = []

    def injected(generator, n, *shape):
        calls.append((generator, n, shape))
        return d

    monkeypatch.setattr(S, "pipeline_draws", injected)
    got = CARLAgent.gather_batch(learner, data, idx)["obs"]["state_image"]
    assert calls == [(learner.generator, N, (PH, PW, C))]
    img = _jax_images(data, idx)
    flat_in = img.max((-3, -2, -1)) == img.min((-3, -2, -1))
    pre = S.distort(_t(img), d, 1.0)
    ill = (pre.amax((-3, -2, -1)) - pre.amin((-3, -2, -1)) < ILL_RANGE).numpy()
    assert ill.any() and (flat_in & ~ill).any() and not (ill & ~flat_in).any()
    want = np.asarray(jax_pipeline(keys, img, 1.0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[~ill], want[~ill], rtol=0, atol=ATOL)
    assert bool(((got >= 0) & (got <= 1)).all()) and ((want >= 0) & (want <= 1)).all()
    identity = lambda x, eps=1e-7: x  # noqa: E731
    monkeypatch.setattr(A, "normalize", identity)
    monkeypatch.setattr(JA, "normalize", identity)
    without = jax.jit(jax.vmap(jax.vmap(JS.carla_augment_pipeline, (None, 0, None)),
                               (0, 0, None)), static_argnums=2)(keys, img, 1.0)
    _close(CARLAgent.gather_batch(learner, data, idx)["obs"]["state_image"], without)


def test_gather_batch_without_augmentation_draws_nothing():
    data, idx = _rollout_data(), torch.tensor([0, 5, 9])
    learner = _learner(0.0)
    state = learner.generator.get_state()
    got = CARLAgent.gather_batch(learner, data, idx)["obs"]["state_image"]
    assert torch.equal(learner.generator.get_state(), state)
    np.testing.assert_array_equal(got.numpy(), _jax_images(data, idx))


# ---------------------------------------------------------------- the ops off the pipeline

def _crop_offsets(ch, cw):
    def offsets(k):
        ky, kx = jax.random.split(k)
        return (jax.random.randint(ky, (), 0, max(H - ch, 0) + 1),
                jax.random.randint(kx, (), 0, max(W - cw, 0) + 1))
    return jax.jit(jax.vmap(offsets))


def _color_distortion_draws(k):
    k1, k2, k3 = jax.random.split(k, 3)
    return (jnp.stack([jax.random.uniform(k1, ()), jax.random.uniform(k3, ())]),
            jnp.stack([jax.random.uniform(kk, ()) for kk in jax.random.split(k2, 4)]))


def _off_pipeline(name, img, keys):
    """(port's output, JAX's) of one op off the pipeline's path."""
    t = _t(img)
    if name in OFF_PIPELINE:
        return OFF_PIPELINE[name](t), jax.jit(jax.vmap(jax.vmap(OFF_PIPELINE_JAX[name])))(img)
    if name.startswith("crop"):
        y0, x0 = (_t(o).long() for o in _crop_offsets(10, 20)(keys))
        do_resize = name == "crop_resize"
        return (A.crop(t, y0, x0, (10, 20), do_resize),
                _per_sample(lambda k, x: JA.crop(k, x, (10, 20), do_resize))(keys, img))
    if name == "flip":
        uh, uv = _split2(lambda k: jax.random.uniform(k, ()),
                         lambda k: jax.random.uniform(k, ()))(keys)
        return (A.flip(t, _t(uh), _t(uv), True, True),
                _per_sample(lambda k, x: JA.flip(k, x, True, True))(keys, img))
    if name == "multiply_channels":
        return (A.multiply_channels(t, _t(_u((C,))(keys)), strength=0.7),
                _per_sample(lambda k, x: JA.multiply_channels(k, x, strength=0.7))(keys, img))
    if name == "jpeg_quality":
        q = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (), 20, 96)))(keys)
        return A.jpeg_quality(t, _t(q)), _per_sample(JA.jpeg_quality)(keys, img)
    gate, jitter = jax.jit(jax.vmap(_color_distortion_draws))(keys)
    return (S.color_distortion(t, _t(gate), _t(jitter), strength=0.5),
            _per_sample(lambda k, x: JS.color_distortion(k, x, strength=0.5))(keys, img))


OFF_PIPELINE = dict(resize_up=lambda x: A.resize(x, (31, 70)),
                    resize_down=lambda x: A.resize(x, (7, 13)),
                    rotate=lambda x: A.rotate(x, 270), grayscale=A.grayscale,
                    repeat_channels=lambda x: A.repeat_channels(A.grayscale(x), 3),
                    median_blur=A.median_blur, sobel=A.sobel, color_drop=S.color_drop)
OFF_PIPELINE_JAX = dict(resize_up=lambda x: JA.resize(x, (31, 70)),
                        resize_down=lambda x: JA.resize(x, (7, 13)),
                        rotate=lambda x: JA.rotate(x, 270), grayscale=JA.grayscale,
                        repeat_channels=lambda x: JA.repeat_channels(JA.grayscale(x), 3),
                        median_blur=JA.median_blur, sobel=JA.sobel, color_drop=JS.color_drop)


@pytest.mark.parametrize("name", sorted(OFF_PIPELINE) + [
    "crop", "crop_resize", "flip", "multiply_channels", "jpeg_quality", "color_distortion"])
def test_off_pipeline_op_matches_jax(name):
    """resize anti-aliases when it shrinks (torch's antialias=True), as
    jax.image.resize does; the drawn ops take JAX's draws (crop's offsets
    and jpeg_quality's quality as drawn, flip's, multiply_channels' and
    color_distortion's uniforms), one per sample."""
    img, keys = _stack(seed=5), _keys(seed=6)
    got, want = _off_pipeline(name, img, keys)
    _close(got, want)
