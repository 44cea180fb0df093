"""models/posegraph4dof.py of the port against vil_fusion_tpu's on
tests/test_visual_loop.py's graphs: the yaw-drift chain closed by one loop
edge (:60) and two sessions stitched by a loop (:192).

The body's fixed-order sums equal the reference's scatter-add on exact
(integer-valued) blocks; through the graph path (graphs.step mocked on the
CPU) optimize is its body bit for bit.

Tolerances: add_node / add_loop write the same float32 values (equal);
`optimize` (10 GN steps of a 64-iteration PCG in float32, the edge
Jacobian written out in the port and taken by jax.jacfwd in the reference)
within 1e-5 m and 1e-5 rad of the reference's solution; drift_transform
within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import posegraph4dof as jpg
from vil_fusion_tpu_torch.models import posegraph4dof as tpg

torch.set_num_threads(2)


def _yaw_chain():
    """30 nodes along x with 0.01 rad of yaw drift a step, the loop edge
    from node 0 to node 29 at the truth."""
    gj, gt = jpg.init_graph(128, 16), tpg.init_graph(128, 16, device="cpu")
    p, yaw = np.zeros(3), 0.0
    for _ in range(30):
        gj = jpg.add_node(gj, jnp.asarray(p, jnp.float32), jnp.float32(yaw), jnp.float32(0.02),
                          jnp.float32(-0.01))
        gt = tpg.add_node(gt, torch.tensor(p, dtype=torch.float32), yaw, 0.02, -0.01)
        yaw += 0.01
        p = p + np.array([np.cos(yaw), np.sin(yaw), 0.0])
    gj = jpg.add_loop(gj, jnp.int32(0), jnp.int32(29), jnp.asarray([29.0, 0, 0], jnp.float32),
                      jnp.float32(0.0))
    gt = tpg.add_loop(gt, 0, 29, torch.tensor([29.0, 0, 0]), 0.0)
    return gj, gt, 29


def _sessions():
    """Two sessions of 10 nodes, the second 5 m off, stitched by a loop from
    node 2 to node 10 at the same place."""
    gj, gt = jpg.init_graph(64, 8), tpg.init_graph(64, 8, device="cpu")
    for s, y0 in ((0, 0.0), (1, 5.0)):
        for i in range(10):
            p = np.array([float(i), y0, 0.0], np.float32)
            gj = jpg.add_node(gj, jnp.asarray(p), jnp.float32(0.0), jnp.float32(0.0),
                              jnp.float32(0.0), s)
            gt = tpg.add_node(gt, torch.from_numpy(p), 0.0, 0.0, 0.0, s)
    gj = jpg.add_loop(gj, jnp.int32(2), jnp.int32(10), jnp.zeros(3, jnp.float32),
                      jnp.float32(0.0))
    gt = tpg.add_loop(gt, 2, 10, torch.zeros(3), 0.0)
    return gj, gt, 10


def _assert_graph_equal(gt, gj, atol=0.0):
    for f in jpg.PoseGraph4DoF._fields:
        np.testing.assert_allclose(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                   atol=atol, rtol=0, err_msg=f)


@pytest.mark.parametrize("build", [_yaw_chain, _sessions])
def test_optimize_and_drift_match_reference(build):
    gj, gt, node = build()
    _assert_graph_equal(gt, gj)
    before = {f: v.clone() for f, v in gt._asdict().items()}
    oj, ot = jpg.optimize(gj), tpg.optimize(gt)
    for f, v in gt._asdict().items():  # the input graph is left as it was
        assert torch.equal(v, before[f]), f
    np.testing.assert_allclose(ot.p.numpy(), np.asarray(oj.p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ot.yaw.numpy(), np.asarray(oj.yaw), atol=1e-5, rtol=0)
    for a, b in zip(tpg.drift_transform(gt, ot, node), jpg.drift_transform(gj, oj, node)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_yaw_chain_closes_and_sessions_stitch():
    """tests/test_visual_loop.py's outcomes on the port: the chain's end
    moves to under a quarter of its error, pitch / roll stay fixed; the
    second session is pulled onto the first by the loop, the first stays
    anchored and the second keeps its shape."""
    _, gt, n = _yaw_chain()
    truth = torch.tensor([29.0, 0.0, 0.0])
    before = float(torch.linalg.norm(gt.p[n] - truth))
    ot = tpg.optimize(gt)
    after = float(torch.linalg.norm(ot.p[n] - truth))
    assert before > 1.0 and after < 0.25 * before, (before, after)
    np.testing.assert_allclose(ot.pitch[:30].numpy(), 0.02, atol=1e-6)
    _, gs, _ = _sessions()
    o2 = tpg.optimize(gs)
    assert float(torch.linalg.norm(o2.p[10] - o2.p[2])) < 0.2
    np.testing.assert_allclose(o2.p[:10, 1].numpy(), 0.0, atol=0.2)
    np.testing.assert_allclose((o2.p[11] - o2.p[10]).numpy(), [1.0, 0.0, 0.0], atol=0.1)


def test_edge_jacobian_matches_autodiff():
    """The written-out Jacobian of the 4-DoF edge residual equals forward
    mode autodiff of the residual (float64, random edges, yaw wrap
    included)."""
    rng = np.random.default_rng(3)
    E = 16
    args = [torch.tensor(rng.normal(size=s) * sc, dtype=torch.float64)
            for s, sc in (((E, 3), 5.0), ((E,), 3.0), ((E, 2), 0.2), ((E, 3), 5.0), ((E,), 3.0),
                          ((E, 3), 2.0), ((E,), 1.0))]
    r, J = tpg._edge_residual_jacobian(*args)

    def res(x, pr_i, t_m, yaw_m):  # one edge, x = (p_i, yaw_i, p_j, yaw_j)
        return tpg._edge_residual_jacobian(x[None, 0:3], x[None, 3], pr_i[None], x[None, 4:7],
                                           x[None, 7], t_m[None], yaw_m[None])[0][0]

    x0 = torch.cat([args[0], args[1][:, None], args[3], args[4][:, None]], dim=1)
    J_ad = torch.func.vmap(torch.func.jacfwd(res))(x0, args[2], args[5], args[6])
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-10)
    np.testing.assert_allclose(r.numpy(), torch.func.vmap(res)(x0, args[2], args[5],
                                                               args[6]).numpy(), atol=1e-12)


def _graph_stand_in(monkeypatch, calls):
    """graphs.use_graph mocked true and graphs.step a stand-in that records
    (name, static, lock) and runs the body inline, as a capture would."""
    from vil_fusion_tpu_torch.utils import graphs

    def step(name, fn, args, static=(), lock=None):
        hash(static)
        calls.append((name, static, lock))
        with graphs.inline():
            return fn(*args)

    monkeypatch.setattr(graphs, "use_graph", lambda x: True)
    monkeypatch.setattr(graphs, "step", step)


@pytest.mark.parametrize("build", [_yaw_chain, _sessions])
def test_optimize_graph_path_is_the_body(build, monkeypatch):
    """optimize through the graph path (graphs.step mocked on the CPU): one
    call of "posegraph4dof_optimize" keyed on (gn_iters, cg_iters,
    lm_lambda), no lock taken (its callers hold the pipeline's step lock),
    the body's result bit for bit, the reference's within 1e-5, and the
    input graph left as it was (the body writes nothing)."""
    gj, gt, _ = build()
    want = tpg.optimize(gt)
    before = {f: v.clone() for f, v in gt._asdict().items()}
    calls = []
    _graph_stand_in(monkeypatch, calls)
    got = tpg.optimize(gt)
    assert calls == [("posegraph4dof_optimize", (10, 64, 0.02), None)]
    for f in ("p", "yaw"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f, v in gt._asdict().items():
        assert torch.equal(v, before[f]), f
    oj = jpg.optimize(gj)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(oj.p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.yaw.numpy(), np.asarray(oj.yaw), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,n_loops", [(8, 3), (64, 5), (128, 0)])
def test_fixed_order_sums_equal_the_scatter(n, n_loops):
    """The body's per-node sums (the sequential edges' table, the loop
    edges' one-hots) against the reference's scatter-add, on integer-valued
    blocks of every edge, the clamped edges of the last nodes included
    (every order sums them exactly): equal, with n_loops loop slots in use.
    The last node sums the most rows: its 4 edges as i, 14 as j."""
    rng = np.random.default_rng(n)
    seq_i, seq_j, table = tpg._seq_edges(n)
    L = 8
    loop_i = rng.integers(0, n, L)
    loop_j = rng.integers(0, n, L)
    ei = np.concatenate([seq_i, loop_i])
    ej = np.concatenate([seq_j, loop_j])
    rows_i = rng.integers(-50, 50, (len(ei), 4)).astype(np.float32)
    rows_j = rng.integers(-50, 50, (len(ej), 4)).astype(np.float32)
    rows_i[len(seq_i) + n_loops:] = rows_j[len(seq_j) + n_loops:] = 0.0
    want = np.zeros((n, 4), np.float32)
    np.add.at(want, ei, rows_i)
    np.add.at(want, ej, rows_j)
    E = len(seq_i)
    stacked = np.concatenate([rows_i[:E], rows_j[:E], np.zeros((1, 4), np.float32)])
    onehot_i = (loop_i[None, :] == np.arange(n)[:, None]).astype(np.float32)
    onehot_j = (loop_j[None, :] == np.arange(n)[:, None]).astype(np.float32)
    got = stacked[table].sum(1) + onehot_i @ rows_i[E:] + onehot_j @ rows_j[E:]
    np.testing.assert_array_equal(got, want)
    assert table.shape == (n, 4 + 14)
