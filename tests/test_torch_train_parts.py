"""The parts of TEMPURA's predcls training in the port against ``vidsgg``'s,
on the same seeded NumPy inputs, in float64 (JAX in its x64 context):

* ``masked_ce`` / ``masked_bce``: values and gradients, with p = 0 and
  p = 1 exactly, saturated heads and class weights;
* the three contrastive losses: values and gradients;
* train-mode ``MaskedBatchNorm``: output, input and parameter gradients,
  running statistics (channels last, and channels first as the pair
  features' convs use it);
* the GMM head's train phase with the same injected noise, and ``unc``;
* ``accumulate_memory`` + ``finalize_memory`` for every weight type, and
  ``uncertainty_stats``;
* the optimizer (clip, the reference AdamW, the schedule) over 8 steps
  across epoch boundaries on seeded gradients, one tensor all zero, one
  starting late, one with no gradient at all (None in the port, zeros
  in ``vidsgg``) and a packed q/k/v tensor whose k block never trains
  (three tensors in ``vidsgg``), against ``vidsgg.train.make_optimizer``;
* the learning rate at the epoch boundaries.

Tolerance: 1e-12 x max(1, max|ref|) (every one of these is a few float64
operations in the same order; the sums may associate differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.debias import memory as jmem
from vidsgg.losses import contrastive as jcon
from vidsgg.losses import relation as jrel
from vidsgg.models.gmm_head import GMMHead as JGMMHead
from vidsgg.models.norm import MaskedBatchNorm as JMaskedBatchNorm
from vidsgg.train.optim import make_optimizer, reference_lr_schedule
from vidsgg_torch.convert import _gmm_head
from vidsgg_torch.debias import memory as tmem
from vidsgg_torch.losses import contrastive as tcon
from vidsgg_torch.losses import relation as trel
from vidsgg_torch.models.gmm_head import GMMHead
from vidsgg_torch.models.noise import ReplayNoise
from vidsgg_torch.models.norm import MaskedBatchNorm
from vidsgg_torch.train.optim import ReferenceAdamW, reference_lr
from torch_parity_utils import entry_to_torch

TOL = 1e-12


def close(got, want, name="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64), requires_grad=True)


def _probs(rng, n, c):
    p = rng.random((n, c))
    p[0, :3] = (0.0, 1.0, 1e-40)           # exactly 0 and 1; log(1e-40) = -92.1 passes
    p[1, :3] = (1.0 - 1e-17, 1e-300, 0.5)  # rounds to 1; below e^-100: clamped
    p[2] = 1.0                             # a saturated row
    return p


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_ce_value_and_grad(weighted):
    rng = np.random.default_rng(0)
    x = _probs(rng, 9, 5)
    labels = rng.integers(0, 5, 9)
    mask = np.arange(9) < 7
    w = np.ones(5) if not weighted else np.r_[0.3, np.ones(4)]
    with jax.enable_x64(True):
        jw = jnp.asarray(w) if weighted else None
        val, grad = jax.value_and_grad(
            lambda a: jrel.masked_ce(a, jnp.asarray(labels), jnp.asarray(mask), jw))(jnp.asarray(x))
    tx = t64(x)
    got = trel.masked_ce(tx, torch.from_numpy(labels), torch.from_numpy(mask),
                         torch.from_numpy(w) if weighted else None)
    got.backward()
    close(got, val, "value")
    close(tx.grad, grad, "grad")


@pytest.mark.parametrize("c", [6, 17])
def test_masked_bce_value_and_grad_at_zero_one_and_saturation(c):
    rng = np.random.default_rng(c)
    p = _probs(rng, 10, c)
    t = (rng.random((10, c)) < 0.4).astype(np.float64)
    t[0, :3] = (1.0, 0.0, 1.0)   # log(0) and log(1 - 1) taken: both clamp to -100
    mask = np.arange(10) < 8
    with jax.enable_x64(True):
        val, grad = jax.value_and_grad(
            lambda a: jrel.masked_bce(a, jnp.asarray(t), jnp.asarray(mask)))(jnp.asarray(p))
    tp = t64(p)
    got = trel.masked_bce(tp, torch.from_numpy(t), torch.from_numpy(mask))
    got.backward()
    assert np.isfinite(tp.grad.numpy()).all()
    close(got, val, "value")
    close(tp.grad, grad, "grad")


@pytest.mark.parametrize("name", ["contrastive_loss", "euc_norm_loss", "supcon_loss"])
def test_contrastive_losses_value_and_grad(name):
    rng = np.random.default_rng(3)
    # no duplicate rows: at distance 0, sqrt(d2 + 1e-12) turns the dot
    # products' last-bit rounding into a 1e-10 change of the distance
    f = rng.standard_normal((12, 6))
    labels = rng.integers(0, 3, 12)
    # supcon is NaN with a padding row, in vidsgg as in the port
    valid = np.ones(12, bool) if name == "supcon_loss" else np.arange(12) < 10
    with jax.enable_x64(True):
        val, grad = jax.value_and_grad(lambda a: getattr(jcon, name)(
            a, jnp.asarray(labels), jnp.asarray(valid)))(jnp.asarray(f))
    tf = t64(f)
    got = getattr(tcon, name)(tf, torch.from_numpy(labels), torch.from_numpy(valid))
    got.backward()
    # euc_norm_loss averages self distances too: sqrt(d2 + 1e-12) of a d2
    # that is the rounding noise of |f|^2 + |f|^2 - 2 f.f, where one ulp of
    # 2 (4.4e-16) moves the distance by 2.2e-10
    tol = 1e-9 if name == "euc_norm_loss" else TOL
    close(got, val, "value", tol)
    close(tf.grad, grad, "grad", tol)


@pytest.mark.parametrize("channels_first", [False, True])
def test_masked_batchnorm_train_mode(channels_first):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 5, 5, 8)) * 2 + 1        # NHWC, as vidsgg's
    mask = np.broadcast_to((np.arange(6) < 4)[:, None, None], x.shape[:-1])
    r = rng.standard_normal(x.shape)
    stats = dict(mean=rng.standard_normal(8) * 0.1, var=0.5 + rng.random(8))
    params = dict(scale=1 + 0.1 * rng.standard_normal(8), bias=0.1 * rng.standard_normal(8))
    with jax.enable_x64(True):
        bn = JMaskedBatchNorm(momentum=0.01)
        jp = jax.tree.map(jnp.asarray, params)

        def loss(xx, pp):
            y, mut = bn.apply({"params": pp, "batch_stats": jax.tree.map(jnp.asarray, stats)},
                              xx, jnp.asarray(mask), use_running_average=False,
                              mutable=["batch_stats"])
            return (y * r).sum(), (y, mut["batch_stats"])

        (_, (y, new_stats)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jp)
    port = MaskedBatchNorm(8, channel_dim=1 if channels_first else -1, momentum=0.01).double()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["scale"]))
        port.bias.copy_(torch.from_numpy(params["bias"]))
        port.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port.running_var.copy_(torch.from_numpy(stats["var"]))
    tx = t64(x.transpose(0, 3, 1, 2) if channels_first else x)
    ty = port(tx, torch.from_numpy(mask.copy()), use_running_average=False)
    if channels_first:
        ty = ty.permute(0, 2, 3, 1)
    (ty * torch.from_numpy(r)).sum().backward()
    close(ty, y, "y")
    gtx = tx.grad.permute(0, 2, 3, 1) if channels_first else tx.grad
    close(gtx, gx, "x grad")
    close(port.weight.grad, gp["scale"], "scale grad")
    close(port.bias.grad, gp["bias"], "bias grad")
    close(port.running_mean, new_stats["mean"], "running mean")
    close(port.running_var, new_stats["var"], "running var")
    # eval mode reads the running statistics
    with jax.enable_x64(True):
        y_eval = bn.apply({"params": jp, "batch_stats": new_stats}, jnp.asarray(x),
                          jnp.asarray(mask), use_running_average=True)
    with torch.no_grad():
        te = port(torch.from_numpy(x.transpose(0, 3, 1, 2) if channels_first else x))
    close(te.permute(0, 2, 3, 1) if channels_first else te, y_eval, "eval y")


def _gmm(rel_type, c, k=6, d=16):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, d))
    with jax.enable_x64(True):
        head = JGMMHead(c, k, rel_type)
        variables = head.init(jax.random.PRNGKey(0), jnp.asarray(x), "test")
        variables = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape)), variables)
    port = GMMHead(d, c, k, rel_type).double()
    sd = {}
    _gmm_head(sd, "h", variables["params"], k)
    port.load_state_dict({kk[2:]: torch.from_numpy(np.array(v)) for kk, v in sd.items()})
    return head, variables, port, x


@pytest.mark.parametrize("rel_type,c", [("attention", 3), ("spatial", 6), ("contact", 17),
                                        (None, 37)])
def test_gmm_head_train_phase_with_injected_noise_and_unc(rel_type, c, monkeypatch):
    head, variables, port, x = _gmm(rel_type, c)
    eps = np.random.default_rng(6).standard_normal((7, 6, c))
    r = np.random.default_rng(7).standard_normal((7, c))
    with jax.enable_x64(True):
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: (
            jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else pytest.fail(shape)))

        def loss(p, xx):
            y = head.apply({"params": p}, xx, "train", rng=jax.random.PRNGKey(1))
            return (y * r).sum(), y

        (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x))
        al, ep = head.apply(variables, jnp.asarray(x), "test", unc=True)
        y_test = head.apply(variables, jnp.asarray(x), "test")
    tx = t64(x)
    noise = ReplayNoise([torch.from_numpy(eps)], [])
    ty = port(tx, "train", noise=noise)
    assert noise.exhausted()
    (ty * torch.from_numpy(r)).sum().backward()
    close(ty, y, "train output")
    close(tx.grad, gx, "x grad")
    sd = {}
    _gmm_head(sd, "h", jax.tree.map(np.asarray, gp), 6)
    grads = {n: p.grad for n, p in port.named_parameters()}
    for kk, v in sd.items():
        close(grads[kk[2:]], v, kk)
    with torch.no_grad():
        tal, tep = port(tx, "test", unc=True)
        close(tal, al, "al_uc")
        close(tep, ep, "ep_uc")
        close(port(tx), y_test, "test output")


CAP = JCap(max_frames=4, max_objs=10, max_pairs=12)


def _memory_inputs(seed):
    rng = np.random.default_rng(seed)
    n, p = CAP.max_objs, CAP.max_pairs
    e = JEntry.zeros(CAP)
    pm = np.arange(p) < 9
    om = np.arange(n) < 8
    labels = np.where(om, rng.integers(0, 37, n), 0).astype(np.int32)
    labels[1] = 0                                   # a background object
    fields = dict(
        attention_gt=rng.integers(0, 3, p).astype(np.int32),
        spatial_gt=(rng.random((p, 6)) < 0.3).astype(np.float64),
        contacting_gt=(rng.random((p, 17)) < 0.2).astype(np.float64),
        pair_mask=pm, obj_mask=om, labels=labels,
    )
    out = {"rel_features": rng.standard_normal((p, 40)),
           "object_features": rng.standard_normal((n, 24))}
    for name, cc in (("attention", 3), ("spatial", 6), ("contacting", 17)):
        out[f"{name}_al_uc"] = rng.random((p, cc))
        out[f"{name}_ep_uc"] = rng.random((p, cc)) * 0.2
    out["obj_al_uc"] = rng.random((n, 37))
    out["obj_ep_uc"] = rng.random((n, 37)) * 0.3
    return e.replace(**fields), out


WEIGHT_TYPES = ["simple", "al", "ep", "both"]


@pytest.mark.parametrize("rel_wt,obj_wt", list(zip(WEIGHT_TYPES, WEIGHT_TYPES[::-1])))
def test_memory_accumulate_and_finalize(rel_wt, obj_wt):
    videos = [_memory_inputs(s) for s in (8, 9, 10)]
    with jax.enable_x64(True):
        acc = jmem.MemoryAccumulator.zeros(rel_dim=40, obj_dim=24)
        for e, out in videos:
            acc = jmem.accumulate_memory(acc, e, jax.tree.map(jnp.asarray, out), rel_wt, obj_wt,
                                         obj_mem=True)
        want_rel, want_obj = jmem.finalize_memory(acc, rel_wt, obj_wt)
        want_stats = jmem.uncertainty_stats(acc)
    tacc = tmem.MemoryAccumulator.zeros(rel_dim=40, obj_dim=24, dtype=torch.float64,
                                        device="cpu")
    for e, out in videos:
        tacc = tmem.accumulate_memory(tacc, entry_to_torch(e),
                                      {k: torch.from_numpy(v) for k, v in out.items()},
                                      rel_wt, obj_wt, obj_mem=True)
    rel, obj = tmem.finalize_memory(tacc, rel_wt, obj_wt)
    for f in dataclasses.fields(tacc):
        close(getattr(tacc, f.name), getattr(acc, f.name), f.name)
    close(rel, want_rel, "rel bank")
    close(obj, want_obj, "obj bank")
    for k, v in tmem.uncertainty_stats(tacc).items():
        close(v, want_stats[k], k)


OPT_SHAPES = {"a": (7, 5), "b": (11,), "zero": (3, 4), "late": (6,), "none": (2, 3)}
STEPS_PER_EPOCH, N_STEPS = 3, 8


def _opt_grads():
    rng = np.random.default_rng(11)
    grads = []
    for t in range(N_STEPS):
        g = {k: rng.standard_normal(s) * (60.0 if t == 2 else 1.0)   # clips at t = 2
             for k, s in OPT_SHAPES.items()}
        g["zero"] = np.zeros(OPT_SHAPES["zero"])
        if t < 4:
            g["late"] = np.zeros(OPT_SHAPES["late"])
            g["none"] = np.zeros(OPT_SHAPES["none"])
        grads.append(g)
    return grads


QKV = ("q", "k", "v")


def test_optimizer_matches_vidsgg_make_optimizer():
    """Also a packed q/k/v tensor (``segments=3`` in the port, three
    tensors in ``vidsgg``) whose k block's gradient is always zero: that
    block is skipped, decay included, while q and v train."""
    rng = np.random.default_rng(10)
    init = {k: rng.standard_normal(s) for k, s in OPT_SHAPES.items()}
    init.update({k: rng.standard_normal((3, 4)) for k in QKV})
    grads = _opt_grads()
    for g in grads:
        g.update({k: rng.standard_normal((3, 4)) for k in QKV})
        g["k"] = np.zeros((3, 4))
    kw = dict(base_lr=1e-3, steps_per_epoch=STEPS_PER_EPOCH)
    with jax.enable_x64(True):
        tx = make_optimizer(**kw)
        params = jax.tree.map(jnp.asarray, init)
        opt_state = tx.init(params)
        want = []
        for g in grads:
            updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
            adam = opt_state[1]
            want.append((jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, adam.mu),
                         jax.tree.map(np.asarray, adam.nu), jax.tree.map(np.asarray, adam.count)))
    def packed(tree):
        return np.concatenate([tree[k] for k in QKV])

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()
               if k not in QKV}
    tparams["qkv"] = torch.nn.Parameter(torch.from_numpy(packed(init)))
    opt = ReferenceAdamW(list(tparams.values()), segments=[1] * len(OPT_SHAPES) + [3], **kw)
    for t, g in enumerate(grads):
        g = dict(g, qkv=packed(g))
        for k, p in tparams.items():
            # the port's "none" tensor has no gradient while vidsgg's is zero
            p.grad = None if (k == "none" and t < 4) else torch.from_numpy(g[k])
        opt.step()
        w_params, w_mu, w_nu, w_count = want[t]
        for tree in (w_params, w_mu, w_nu):
            tree["qkv"] = packed(tree)
        w_count = dict(w_count, qkv=[int(w_count[k]) for k in QKV])
        for k, p in tparams.items():
            st = opt.state[p]
            close(p, w_params[k], f"step {t} {k}")
            close(st["exp_avg"], w_mu[k], f"step {t} {k} m")
            close(st["exp_avg_sq"], w_nu[k], f"step {t} {k} v")
            assert st["step"].tolist() == np.ravel(w_count[k]).tolist(), (t, k)
    assert opt.state[tparams["qkv"]]["step"].tolist() == [N_STEPS, 0, N_STEPS]
    np.testing.assert_array_equal(tparams["qkv"].detach().numpy()[3:6], init["k"])
    assert opt.updates == N_STEPS
    assert int(opt.state[tparams["zero"]]["step"]) == 0
    np.testing.assert_array_equal(tparams["zero"].detach().numpy(), init["zero"])
    assert int(opt.state[tparams["late"]]["step"]) == N_STEPS - 4


def test_optimizer_state_dict_round_trip():
    p = torch.nn.Parameter(torch.randn(4, 3, dtype=torch.float64))
    opt = ReferenceAdamW([p], steps_per_epoch=2)
    for _ in range(3):
        p.grad = torch.randn(4, 3, dtype=torch.float64)
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = ReferenceAdamW([q], steps_per_epoch=2)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.updates == 3
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(opt2.state[q][key], opt.state[p][key])


@pytest.mark.parametrize("steps_per_epoch", [1, 3, 7])
def test_lr_at_epoch_boundaries(steps_per_epoch):
    with jax.enable_x64(True):
        sched = reference_lr_schedule(steps_per_epoch=steps_per_epoch)
        want = [float(sched(jnp.asarray(n))) for n in range(6 * steps_per_epoch + 1)]
    got = [reference_lr(n, steps_per_epoch=steps_per_epoch)
           for n in range(6 * steps_per_epoch + 1)]
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    # the last update of an epoch keeps its epoch's rate; the next one moves
    for e in range(1, 6):
        n = e * steps_per_epoch
        assert got[n - 1] == got[e * steps_per_epoch - steps_per_epoch]
        assert got[n] != got[n - 1]
