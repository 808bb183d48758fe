"""TokenGT's random node identifiers (``rand``, ``orf``) and its Performer
attention in the port against ``vidsgg``, and the port's own draws.

``vidsgg`` draws these from threefry keys (``jax.random.PRNGKey(0)`` at test
time, the dropout and ``performer`` streams in training), which no torch
generator reproduces, so the comparisons hand the port ``vidsgg``'s draws:
the orthogonal random matrices through ``teatgt_parity_utils.DrawBridge``,
the ``rand`` identifiers' uniform draws and every dropout mask through
``train_parity_utils.SharedNoise``. Everything downstream of a draw is
held at 1e-8 x max(1, max|ref|) in float64 (JAX in its x64 context):

* ``favor_attention`` on a given projection with a key mask: the output
  and the gradients of q, k and v;
* ``TokenGTEncoder`` (d = 32, 2 layers x 4 heads, k = 6 and 50) with
  ``rand`` and ``orf`` identifiers and with ``performer=True``: the test
  phase's outputs, and a train-phase forward and backward (a seeded
  cotangent: the gradients of the node features and of every parameter).

The port's own draws are held to their distribution: the orthogonal
random matrix's blocks are orthonormal to 1e-10 in float64 and its row
norms are chi-distributed, the ``rand`` identifiers are unit rows, the
test phase draws the same values on every call, and the train step's
Performer draws change every ``performer_redraw_interval`` steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from teatgt_parity_utils import DrawBridge
from test_torch_teatgt import _close, _tokengt_inputs
from torch_parity_utils import random_tree
from train_parity_utils import SharedNoise

from vidsgg.models.performer import favor_attention as jfavor
from vidsgg.models.tokengt import TokenGTEncoder as JTokenGT
from vidsgg_torch.convert import teatgt_from_jax
from vidsgg_torch.models.noise import Noise, fixed_noise
from vidsgg_torch.models.performer import favor_attention, gaussian_orthogonal_random_matrix
from vidsgg_torch.models.teatgt import TeatGTConfig
from vidsgg_torch.models.tokengt import TokenGTEncoder
from vidsgg_torch.train.steps import performer_noise

TINY = dict(num_atoms=1168, num_output=26, embed_dim=32, layers=2, heads=4, ffn_dim=48)
# (node_id_mode, performer, k)
CONFIGS = {"rand": ("rand", False, 50), "orf": ("orf", False, 6),
           "performer": ("lap", True, 50)}


def _port_tokengt(tree, mode, performer, k):
    """The port's TokenGTEncoder loaded from a ``vidsgg`` TokenGT subtree
    (parameters or their gradients), through the TEAT-GT converter."""
    cfg = TeatGTConfig(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
                       encoder_ffn_embed_dim=48, lap_node_id_k=k, node_id_mode=mode,
                       performer=performer)
    dense = lambda i, o: {"kernel": np.zeros((i, o)), "bias": np.zeros(o)}  # noqa: E731
    full = {"params": {"tokengt": tree, "subj_fc": dense(2048, 968),
                       "obj_fc": dense(2048, 968), "node_label_tokenizer": np.zeros((37, 200)),
                       "gap_gru": {"gate_nn": dense(32, 1)}}}
    return {key[len("TokenGT_encoder."):]: v for key, v in teatgt_from_jax(full, cfg).items()
            if key.startswith("TokenGT_encoder.")}


def test_favor_attention_matches_vidsgg():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 3, 7, 8) for _ in range(3))
    mask = rng.rand(2, 1, 7) > 0.3
    proj = rng.randn(16, 8)
    cot = rng.randn(2, 3, 7, 8)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(lambda q, k, v: jfavor(q, k, v, jnp.asarray(mask), jnp.asarray(proj)),
                            *(jnp.asarray(x) for x in (q, k, v)))
        want_grads = vjp(jnp.asarray(cot))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = favor_attention(tq, tk, tv, torch.from_numpy(mask), torch.from_numpy(proj))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), want, "favor_attention")
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads, strict=True):
        _close(t.grad, w, f"d {name}")


@pytest.mark.parametrize("rows,cols", [(256, 8), (9, 9), (20, 6)])
def test_orthogonal_random_matrix_draws(rows, cols):
    """The port's own draws: each block of ``cols`` rows orthogonal, its rows'
    norms the square roots of chi-square draws of ``cols`` degrees of
    freedom (their squares average ``cols``), the same draws from the same
    seed."""
    m = gaussian_orthogonal_random_matrix(Noise.seeded(5, "cpu"), rows, cols, batch=3,
                                          dtype=torch.float64, device="cpu")
    assert m.shape == (3, rows, cols) and m.dtype == torch.float64
    norms = m.norm(dim=-1, keepdim=True)
    unit = m / norms
    for start in range(0, rows, cols):
        block = unit[:, start:start + cols]
        gram = block @ block.transpose(-1, -2)
        eye = torch.eye(block.shape[1], dtype=torch.float64).expand_as(gram)
        assert float((gram - eye).abs().max()) < 1e-10
    if rows >= 64:
        assert abs(float(norms.square().mean()) / cols - 1.0) < 0.1
    again = gaussian_orthogonal_random_matrix(Noise.seeded(5, "cpu"), rows, cols, batch=3,
                                              dtype=torch.float64, device="cpu")
    assert torch.equal(m, again)


def test_performer_draws_change_every_redraw_interval():
    """The train step's Performer draws (``performer_noise``, the port's
    ``performer_rng``): the same for every step of one redraw interval, new
    at the next; each layer's projection is its own draw."""
    def projections(step, interval=1000):
        noise = performer_noise(step, interval)
        return [gaussian_orthogonal_random_matrix(noise, 16, 8, dtype=torch.float64,
                                                  device="cpu") for _ in range(2)]

    first, last, next_ = projections(0), projections(999), projections(1000)
    assert all(torch.equal(a, b) for a, b in zip(first, last, strict=True))
    assert not any(torch.equal(a, b) for a, b in zip(first, next_, strict=True))
    assert not torch.equal(first[0], first[1])
    assert torch.equal(projections(3, 2)[0], projections(2, 2)[0])


@pytest.mark.parametrize("mode", ["rand", "orf"])
def test_random_identifiers_are_unit_rows(mode):
    """The port's own identifiers: unit rows (a padded ``orf`` column is 0);
    the test phase draws the same on every call, training from the run's
    noise."""
    port = TokenGTEncoder(node_id_mode=mode, lap_node_id_k=50, **TINY).double()
    x = torch.zeros((3, 9, 1168), dtype=torch.float64)
    ids = port.node_identifiers(x, None)
    assert ids.shape == (3, 9, 50) and ids.dtype == torch.float64
    assert float((ids.norm(dim=-1) - 1.0).abs().max()) < 1e-12
    assert torch.equal(ids, port.node_identifiers(x, None))
    if mode == "orf":
        assert not ids[..., 9:].any()
        gram = ids @ ids.transpose(-1, -2)
        assert float((gram - torch.eye(9, dtype=torch.float64)).abs().max()) < 1e-10
    else:
        assert (ids > 0).all()
    train = port.node_identifiers(x, None, deterministic=False, noise=Noise.seeded(1, "cpu"))
    assert float((train.norm(dim=-1) - 1.0).abs().max()) < 1e-12
    assert not torch.equal(train, ids)
    assert torch.equal(fixed_noise().uniform((4,), torch.float64, "cpu"),
                       fixed_noise().uniform((4,), torch.float64, "cpu"))


@pytest.mark.parametrize("case", list(CONFIGS))
def test_tokengt_matches_vidsgg_on_handed_draws(case, monkeypatch):
    mode, performer, k = CONFIGS[case]
    inputs = _tokengt_inputs()
    b, n = inputs[1].shape
    rng = np.random.RandomState(12)
    cots = [rng.randn(b, n, 26), rng.randn(b, n, 32), rng.randn(b, 32)]
    noise = SharedNoise(monkeypatch, heads=(), rows=set())
    bridge = DrawBridge(monkeypatch, noise)
    with jax.enable_x64(True):
        jm = JTokenGT(lap_node_id_k=k, node_id_mode=mode, performer=performer,
                      performer_nb_features=16, **TINY)
        noise.active = False
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
        noise.active = True
        bridge.recorded.clear()
        variables = random_tree(shapes, np.random.default_rng(8), np.float64)
        rest = [jnp.asarray(x) for x in inputs[1:]]
        test_out = [np.asarray(x) for x in jax.jit(lambda p, x: jm.apply({"params": p}, x, *rest))(
            variables["params"], jnp.asarray(inputs[0]))]
        jax.effects_barrier()
        test_replay = noise.replay()
        noise.retrace()
        rngs = {"dropout": jax.random.PRNGKey(4), "performer": jax.random.PRNGKey(6)}

        @jax.jit
        def forward_backward(p, x, cot):
            out, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x, *rest, False, rngs=rngs),
                               p, x)
            return out, vjp(cot)

        want, grads = forward_backward(variables["params"], jnp.asarray(inputs[0]),
                                       tuple(jnp.asarray(c) for c in cots))
        grads = [jax.tree.map(np.asarray, g) for g in grads]
    jax.effects_barrier()
    train_replay = noise.replay()
    draws_per_call = (mode == "orf") + (TINY["layers"] if performer else 0)
    assert len(bridge.recorded) == 2 * draws_per_call
    # the test phase: rand's one uniform draw, no mask
    assert len(test_replay.uniforms) == (mode == "rand") and not test_replay.masks
    # training: the token sequence's mask, four a layer (three with the
    # Performer: no attention dropout), eig dropout and a sign flip with lap
    assert len(train_replay.masks) == 1 + (3 if performer else 4) * 2 + (mode == "lap")
    # rand's identifiers, or lap's sign flips
    assert len(train_replay.uniforms) == (mode != "orf")

    port = TokenGTEncoder(lap_node_id_k=k, node_id_mode=mode, performer=performer,
                          performer_nb_features=16, **TINY).double()
    port.load_state_dict(_port_tokengt(variables["params"], mode, performer, k))
    monkeypatch.setattr("vidsgg_torch.models.tokengt.fixed_noise", lambda: test_replay)
    args = [torch.from_numpy(np.asarray(v)) for v in inputs[1:]]
    with torch.no_grad():
        got = port(torch.from_numpy(inputs[0]), *args)
    assert test_replay.exhausted()
    for name, g, w in zip(("logits", "hidden", "graph_rep"), got, test_out, strict=True):
        _close(g, w, f"test phase {name}")

    x = torch.from_numpy(inputs[0]).requires_grad_()
    got = port(x, *args, deterministic=False, noise=train_replay,
               performer=Noise.seeded(0, "cpu"))
    assert train_replay.exhausted()
    bridge.assert_consumed(2 * draws_per_call)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, g, w in zip(("logits", "hidden", "graph_rep"), got, want, strict=True):
        _close(g.detach(), w, f"train phase {name}")
    _close(x.grad, grads[1], "d node_data")
    want_grads = _port_tokengt(grads[0], mode, performer, k)
    assert sorted(want_grads) == sorted(n for n, _ in port.named_parameters())
    for name, param in port.named_parameters():
        _close(param.grad, want_grads[name], f"d {name}")
