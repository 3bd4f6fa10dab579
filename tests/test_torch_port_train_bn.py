"""Port parity, how the training CLIs' model trains, against the JAX
functions on the CPU: ``bn_mode`` partial and full (loss within 1e-5;
running statistics within 2-3e-6 of the JAX ones, whose own float32
rounding is that large, and within 1e-6 of float64; BN affine parameters
unchanged); ``--bf16`` (loss within 2e-2 relative); ``--remat`` against no
remat (loss, gradients and running statistics bit-exact)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.convert import (
    convert_torch_backbone_state as j_convert_backbone)
from action_detection_tpu.train import LossWeights as JLossWeights
from action_detection_tpu.train import make_optimizer as j_make_optimizer
from action_detection_tpu.train import make_train_step as j_make_train_step
from action_detection_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from action_detection_torch.config import SamplingConfig
from action_detection_torch.models import SSN, seeded_init, state_dict_from_jax
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones.common import commit_batch_stats
from action_detection_torch.train import (LossWeights, batch_to_device,
                                          make_loss_fn, make_optimizer,
                                          make_train_step)

from tests.test_torch_port_train_optim import (JSPEC, SEG, _close, _jb,
                                               _jstate, _pair, batches)

__all__ = ["batches"]     # the module-scoped fixture, shared


@pytest.mark.parametrize("bn_mode", ["full", "partial"])
def test_bn_mode_train_steps_match_jax(batches, bn_mode):
    """TinyConv SSN, two train steps: loss within 1e-5, running statistics
    within 2e-6 of their largest value (flax updates them with momentum 0.9
    and the biased batch variance), BN affine parameters unchanged. The JAX
    TinyConv trains BN only in ``full``: ``partial`` leaves it frozen.

    Why 2e-6: flax's float32 variance ``E[x^2] - E[x]^2`` of conv1's
    outputs (~3,400 here) is itself ~1.0e-6 off its float64 value, the
    port's ~2e-7 (summation orders differ); 1e-6 fails by JAX's rounding
    alone (1.14e-6 measured)."""
    jm, v, tm = _pair(bn_mode)
    tx = j_make_optimizer(base_lr=0.01, lr_steps=[10], steps_per_epoch=1)
    state = _jstate(v, tx)
    jstep = j_make_train_step(jm, tx, JSamplingConfig(), JSPEC,
                              JLossWeights(), donate=False)
    opt = make_optimizer(tm, base_lr=0.01, lr_steps=[10], steps_per_epoch=1)
    step = make_train_step(tm, opt, SamplingConfig(), LossWeights())
    start = {k: t.clone() for k, t in tm.state_dict().items()}
    for b in batches[:2]:
        state, jmet = jstep(state, _jb(b), jax.random.PRNGKey(0))
        met = step(batch_to_device(b, "cpu"))
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(state.params),
                               jax.device_get(state.batch_stats))
    got = tm.state_dict()
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    _close({k: got[k] for k in stats}, {k: want[k] for k in stats}, 2e-6,
           "running stats")
    changed = any(not torch.equal(got[k], start[k]) for k in stats)
    assert changed == (bn_mode == "full")
    for k in got:
        if "_bn." in k and k.endswith(("weight", "bias")):
            assert torch.equal(got[k], start[k]), k
            np.testing.assert_array_equal(want[k].numpy(), start[k].numpy())


def test_bninception_partial_bn_matches_flax():
    """BNInception at 64^2, ``bn_mode="partial"``, in train mode: features
    and the updated running statistics against flax's mutable
    ``batch_stats``; only ``conv1_7x7_s2_bn`` moves, and its statistics
    are within 1e-6 of their float64 values (flax's float32 ones are
    2.1e-6 off them here, so the two agree to 3e-6)."""
    jbb, _, _ = j_get_backbone("BNInception", "RGB", bn_mode="partial")
    seeded = seeded_init(get_backbone("BNInception", "RGB")[0], seed=1)
    p, st = j_convert_backbone(seeded.state_dict(), "BNInception")
    v = {"params": p, "batch_stats": st}
    x = (np.random.RandomState(0).rand(6, 64, 64, 3) * 255.0
         - 117.0).astype(np.float32)
    ref, new = jax.jit(lambda v, x: jbb.apply(v, x, True,
                                              mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    bb, _, _ = get_backbone("BNInception", "RGB", bn_mode="partial")
    start = state_dict_from_jax(jax.device_get(v["params"]),
                                jax.device_get(v["batch_stats"]))
    bb.load_state_dict(start)
    with torch.no_grad():
        got = bb.train()(torch.from_numpy(x))
        y = bb.conv1_7x7_s2.double()(
            torch.from_numpy(x).double().permute(0, 3, 1, 2))
        bb.conv1_7x7_s2.float()
    commit_batch_stats(bb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    want = state_dict_from_jax(jax.device_get(v["params"]),
                               jax.device_get(new["batch_stats"]))
    sd = bb.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    _close({k: sd[k] for k in stats}, {k: want[k] for k in stats}, 3e-6,
           "partial")
    moved = {k.split(".")[0] for k in stats
             if not torch.equal(sd[k], start[k])}
    assert moved == {"conv1_7x7_s2_bn"}
    m64 = y.mean((0, 2, 3))
    exact = {"running_mean": m64,
             "running_var": (y * y).mean((0, 2, 3)) - m64 * m64}
    for name, batch in exact.items():
        k = f"conv1_7x7_s2_bn.{name}"
        truth = 0.9 * start[k].double() + 0.1 * batch
        err = (sd[k].double() - truth).abs().max() / truth.abs().max()
        assert err <= 1e-6, (k, err.item())


def test_bf16_loss_matches_jax(batches):
    """--bf16 on TinyConv: the loss within 2e-2 relative of the flax model
    with dtype bfloat16, and the parameters stay float32."""
    jm, v, tm = _pair(bf16=True)
    jloss = jax.jit(j_make_loss_fn(jm, JSamplingConfig(), JSPEC),
                    static_argnums=4)
    b = batches[0]
    want, _ = jloss(v["params"], v["batch_stats"], _jb(b),
                    jax.random.PRNGKey(0), True)
    got, _ = make_loss_fn(tm, SamplingConfig())(batch_to_device(b, "cpu"))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


@pytest.mark.parametrize("arch,hw,bn_mode", [("TinyConv", 32, "full"),
                                             ("BNInception", 64, "frozen"),
                                             ("BNInception", 64, "full"),
                                             ("InceptionV3", 96, "partial")])
def test_remat_bit_exact(batches, arch, hw, bn_mode):
    """--remat (each stem layer and each module checkpointed) gives the
    loss, every gradient and the committed running statistics of the plain
    backward, bit for bit."""
    b = dict(batches[0])
    r = hw // 32
    b["frames"] = np.repeat(np.repeat(b["frames"], r, axis=2), r, axis=3)
    out = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = SSN(num_class=3, base_model=arch, dropout=0.0, bn_mode=bn_mode,
                remat=remat, **SEG)
        if out:
            m.load_state_dict(out[0][3])
        start = {k: t.clone() for k, t in m.state_dict().items()}
        loss, _ = make_loss_fn(m, SamplingConfig())(batch_to_device(b,
                                                                    "cpu"))
        loss.backward()
        commit_batch_stats(m)
        out.append((loss.detach(), {n: p.grad.clone()
                                    for n, p in m.named_parameters()},
                    {k: t.clone() for k, t in m.state_dict().items()},
                    start))
    (l0, g0, s0, _), (l1, g1, s1, _) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
