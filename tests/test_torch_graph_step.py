"""The pieces of the captured estimator step that the CPU can run:
ops/linalg.sym_eigh (the eigensolver's dispatcher) against
torch.linalg.eigh and the reference's jnp.linalg.eigh, the graph module's
argument flattening, host constants and launch counting
(utils/graphs.py), graphs.cond (the port's lax.cond) outside a capture
and under a mocked one, the branch-aware settlement of conditional
launches, the CUDA-only entry points refusing CPU tensors, and the
capture policy across threads under a mocked capture (the visual-loop
worker captures holding the pipeline's step lock without taking it again,
while the main thread replays).
The kernel itself and the graph replays are held on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: sym_eigh on the CPU is torch.linalg.eigh, bit for bit; against
the reference's eigh (another LAPACK path) the eigenvalues within 1e-5 of
the largest and the reconstruction V diag(S) V^T within 1e-5 of max|A|
(float32, n <= 157: a few ulps times sqrt(n)).
"""
import contextlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu_torch.models.window import (
    FeatureStore, WindowState, init_features, init_window,
)
from vil_fusion_tpu_torch.ops import linalg
from vil_fusion_tpu_torch.ops.cuda import eigh_cuda
from vil_fusion_tpu_torch.utils import graphs


def _sym(n, seed, rank=None):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(rank or n + 5, n)).astype(np.float32)
    return A.T @ A


@pytest.mark.parametrize("n,rank", [(15, None), (157, None), (157, 60)])
def test_sym_eigh_cpu_is_torch_eigh(n, rank):
    """On a CPU tensor the dispatcher is the plain version, bit for bit, and
    agrees with the reference's jnp.linalg.eigh (full rank and a PSD matrix
    of rank 60 like a marginalization prior's)."""
    A = _sym(n, n, rank)
    S, V = linalg.sym_eigh(torch.from_numpy(A))
    S0, V0 = torch.linalg.eigh(torch.from_numpy(A))
    assert torch.equal(S, S0) and torch.equal(V, V0)
    Sj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    np.testing.assert_allclose(S.numpy(), Sj, atol=1e-5 * np.abs(Sj).max())
    R = (V.numpy() * S.numpy()[None, :]) @ V.numpy().T
    np.testing.assert_allclose(R, A, atol=1e-5 * np.abs(A).max())


def test_sym_eigh_batched_reads_the_lower_triangle():
    """A leading batch dimension, and only the lower triangle read (an
    upper triangle of garbage changes nothing), as torch.linalg.eigh."""
    A = np.stack([_sym(15, s) for s in range(3)])
    junk = A + np.triu(np.full((15, 15), 7.0, np.float32), 1)
    S, V = linalg.sym_eigh(torch.from_numpy(junk))
    for b in range(3):
        S0, _ = torch.linalg.eigh(torch.from_numpy(A[b]))
        assert torch.equal(S[b], S0)


def test_eigh_cuda_refuses_cpu_tensors():
    """The CUDA wrapper takes nothing but CUDA float32 (..., n, n) with
    n <= 172: a CPU tensor raises instead of falling back."""
    with pytest.raises(ValueError, match="CUDA"):
        eigh_cuda.eigh(torch.eye(4))
    assert eigh_cuda.MAX_N == 172 and eigh_cuda.eigh_plain is torch.linalg.eigh


def test_flatten_round_trip():
    """graphs._flatten / _unflatten: NamedTuples (nested), tuples, dicts and
    numbers keep their structure and leaves; the structure is hashable (it
    keys the graph cache)."""
    w = init_window(device="cpu")
    f = init_features(4, device="cpu")
    args = (w, f, (w.p, 3), {"a": w.q, "b": True}, 2.5)
    leaves = []
    spec = graphs._flatten(args, leaves)
    hash(spec)
    out = graphs._unflatten(spec, iter(leaves))
    assert type(out[0]) is WindowState and type(out[1]) is FeatureStore
    assert out[2][1] == 3 and out[3]["b"] is True and out[4] == 2.5
    assert all(a is b for a, b in zip(out[0], w)) and out[3]["a"] is w.q
    assert len(leaves) == len(w) + len(f) + 2 + 2 + 1
    sig = tuple(graphs._signature(x) for x in leaves)
    assert sig[-1] is float and sig[0] == ((11, 3), torch.float32, torch.device("cpu"))
    with pytest.raises(TypeError):
        graphs._signature("text")


def test_host_constant_is_made_once():
    """host_constant gives the same tensor for the same (values, dtype,
    device), built from tuples, lists or numpy arrays alike, with the
    values of torch.tensor."""
    a = graphs.host_constant((0.0, 0.0, 9.81), torch.float32, "cpu")
    b = graphs.host_constant([0.0, 0.0, 9.81], torch.float32, torch.device("cpu"))
    c = graphs.host_constant(np.array([0.0, 0.0, 9.81]), torch.float32, "cpu")
    assert a is b is c
    assert torch.equal(a, torch.tensor([0.0, 0.0, 9.81]))
    d = graphs.host_constant((0.0, 0.0, 9.81), torch.float64, "cpu")
    assert d is not a and d.dtype == torch.float64
    m = graphs.host_constant(np.diag([1.0, 2.0]), torch.float32, "cpu")
    assert torch.equal(m, torch.diag(torch.tensor([1.0, 2.0])))


def test_record_launch_counts_outside_a_capture():
    """A wrapper's launch is counted at once when no graph is being
    captured (on this thread); the eigensolver's counts reset to 0."""
    seen = []
    graphs.record_launch(lambda *a: seen.append(a), 157, 1)
    assert seen == [(157, 1)]
    eigh_cuda.reset_counts()
    graphs.record_launch(eigh_cuda._count)
    assert eigh_cuda.eigh.launches == 1
    eigh_cuda.reset_counts()
    assert eigh_cuda.eigh.launches == 0


def test_step_refuses_cpu_tensors():
    """graphs.step captures only CUDA work: CPU tensors raise (the callers
    run their eager body on the CPU), and nothing is cached."""
    n_before = len(graphs._steps)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.step("test", lambda x: x + 1, (torch.ones(3),), lock=threading.Lock())
    assert len(graphs._steps) == n_before


def test_pipeline_upload_on_cpu():
    """graphs.upload, the pipeline's and global fusion's uploads: a host
    array on the CPU device is the array's values, as `dtype` where one is
    given (the card's path goes through pinned memory)."""
    x = np.arange(12, dtype=np.int16).reshape(4, 3)[:, ::2]
    t = graphs.upload(x, torch.device("cpu"))
    assert t.dtype == torch.int16 and np.array_equal(t.numpy(), x)
    t = graphs.upload(x, torch.device("cpu"), torch.float32)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), x)


class _FakeBodies:
    """cond_cuda.body replaced: records each body opened (its predicate's
    value and negation) and closed, in order; yields a body handle."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, pred, negate, pools):
        self.events.append(("begin", bool(pred), negate))
        yield len(self.events)
        self.events.append(("end",))


@pytest.fixture
def fake_capture(monkeypatch):
    """This thread's capture state mocked (torch's capture query, the
    recording lists graphs.step sets up) and the conditional bodies
    recorded instead of captured (the bodies run eagerly)."""
    from vil_fusion_tpu_torch.ops.cuda import cond_cuda

    bodies = _FakeBodies()
    monkeypatch.setattr(cond_cuda, "body", bodies)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for name in ("capturing", "cond_launches", "preds", "bodies", "body_pools"):
        monkeypatch.setattr(graphs._tls, name, [], raising=False)
    assert graphs.capturing()
    return bodies


def test_cond_outside_a_capture_selects(monkeypatch):
    """graphs.cond with no capture under way runs both branches and selects
    every leaf with torch.where (a leaf both return is taken as it is),
    over nested NamedTuples and dicts; the branches must return one
    structure."""
    w = init_window(device="cpu")
    calls = []

    def t(w, d):
        calls.append("t")
        return w._replace(p=w.p + 1), {"a": d["a"] * 2, "b": d["b"]}

    def f(w, d):
        calls.append("f")
        return w._replace(p=w.p - 1), {"a": d["a"] * 3, "b": d["b"]}

    d = {"a": torch.arange(4.0), "b": torch.ones(2)}
    for key in (True, False):
        out = graphs.cond(torch.tensor(key), t, f, (w, d))
        ref = (t if key else f)(w, d)
        assert type(out[0]) is WindowState and out[1]["b"] is d["b"]
        assert all(torch.equal(x, y) for x, y in zip(out[0], ref[0]))
        assert torch.equal(out[1]["a"], ref[1]["a"])
    assert calls == ["t", "f", "t", "t", "f", "f"]
    with pytest.raises(ValueError, match="structures"):
        graphs.cond(torch.tensor(True), lambda x: (x, x), lambda x: x, (torch.ones(2),))


def test_cond_capture_opens_a_body_a_branch(fake_capture):
    """While capturing, graphs.cond opens one IF body for the true branch
    (on the predicate) and then one for the false branch (on its
    negation), each closed before the next, and records the predicate and
    both body handles for the capture."""
    x = torch.arange(3.0)
    pred = torch.tensor(True)
    graphs.cond(pred, lambda a: a + 1, lambda a: a * 2, (x,))
    assert fake_capture.events == [("begin", True, False), ("end",),
                                   ("begin", True, True), ("end",)]
    assert graphs._tls.preds == [pred] and graphs._tls.bodies == [1, 3]


def test_cond_capture_copies_false_outputs_into_true_outputs(fake_capture):
    """The false body copies its outputs into the true body's, which are
    the node's result: the bodies ran eagerly here, so the result holds the
    false branch's values, in the true branch's tensors."""
    x = torch.arange(4.0)
    held = []

    def t(a):
        held.append(a + 1)
        return held[0], {"k": a * 0}

    out = graphs.cond(torch.tensor(True), t, lambda a: (a * 10, {"k": a - 5}), (x,))
    assert out[0] is held[0] and torch.equal(out[0], x * 10)
    assert torch.equal(out[1]["k"], x - 5)
    with pytest.raises(ValueError, match="structures"):
        graphs.cond(torch.tensor(True), lambda a: a[:2] + 1, lambda a: a + 1, (x,))


def test_cond_capture_clones_outputs_that_alias(fake_capture):
    """A true output that is an operand, a view of one, or a tensor it
    returns twice is cloned inside the body, so the false body's copy
    writes no input of the step: the operands keep their values."""
    x, y = torch.arange(4.0), torch.full((2,), 7.0)
    out = graphs.cond(torch.tensor(True), lambda a, b: (a, b[:1], a),
                      lambda a, b: (a * 2, b[1:] + 1, a * 3), (x, y))
    assert torch.equal(x, torch.arange(4.0)) and torch.equal(y, torch.full((2,), 7.0))
    assert torch.equal(out[0], x * 2) and torch.equal(out[1], y[1:] + 1)
    assert torch.equal(out[2], x * 3)
    assert len({o.untyped_storage().data_ptr() for o in out} | {
        x.untyped_storage().data_ptr(), y.untyped_storage().data_ptr()}) == 5


def test_cond_capture_tags_launches_by_branch(fake_capture):
    """A launch recorded inside a body is kept with its branch (the cond's
    index, 0 true / 1 false), apart from the launches outside any body,
    which every replay counts; a cond nested in a body carries both."""
    x = torch.ones(2)

    def t(a):
        graphs.record_launch(print, "t")
        graphs.cond(torch.tensor(False), lambda b: graphs.record_launch(print, "tt") or b,
                    lambda b: b * 2, (a,))
        return a + 1

    graphs.record_launch(print, "outside")
    graphs.cond(torch.tensor(True), t, lambda a: graphs.record_launch(print, "f") or a * 2, (x,))
    assert graphs._tls.capturing == [(print, ("outside",))]
    assert [(a[0], c) for _, a, c in graphs._tls.cond_launches] == [
        ("t", ((0, 0),)), ("tt", ((0, 0), (1, 0))), ("f", ((0, 1),))]


class _Landed:
    """A settlement's event stand-in: query() is True once `ready`."""

    def __init__(self, ready):
        self.ready = ready

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True


@pytest.mark.parametrize("flags", [(True, False), (False, False), (True, True)])
def test_settle_counts_the_taken_bodies(flags):
    """graphs.settle counts, for every replay whose predicates have landed,
    the launches of the bodies it ran (each of a launch's (cond, branch)
    tags taken: branch 0 where the predicate held, 1 where it did not) and
    none of the others; a replay still in flight waits unless `wait`;
    reset_counts drops the unsettled ones."""
    seen = []

    def settlement(ready):
        s = object.__new__(graphs._Settlement)
        s.launches = [(seen.append, ("t0",), ((0, 0),)), (seen.append, ("f0",), ((0, 1),)),
                      (seen.append, ("t0 t1",), ((0, 0), (1, 0))),
                      (seen.append, ("t0 f1",), ((0, 0), (1, 1)))]
        s.host, s.event = torch.tensor(flags), _Landed(ready)
        return s

    want = {(True, False): ["t0", "t0 f1"], (False, False): ["f0"],
            (True, True): ["t0", "t0 t1"]}[flags]
    graphs.reset_counts()
    later = settlement(False)
    graphs._pending.extend([settlement(True), later])
    assert graphs.settle() == 1 and seen == want
    assert graphs.settle() == 0 and later in graphs._pending
    assert graphs.settle(wait=True) == 1 and seen == want * 2 and not graphs._pending
    assert sorted(x for _, (x,) in later.launches_of(taken=False)) == sorted(
        {"t0", "f0", "t0 t1", "t0 f1"} - set(want))
    graphs._pending.append(settlement(True))
    graphs.reset_counts()
    assert graphs.settle(wait=True) == 0 and seen == want * 2


@pytest.fixture
def fake_captures(monkeypatch):
    """graphs.step's capture mocked (CapturedStep and the device check), as
    in test_torch_frame_graph.py: a capture records its name and lock,
    takes the lock if one is given, and waits for `release` when its name
    is in `hold`; a replay runs fn."""
    made, hold, release = [], set(), threading.Event()

    class Fake:
        def __init__(self, name, fn, args, lock=None):
            made.append((name, lock))
            with lock if lock is not None else contextlib.nullcontext():
                if name in hold:
                    assert release.wait(timeout=20.0), "the capture was never released"
            self.name, self.fn, self.stats = name, fn, dict(name=name)

        def __call__(self, *args):
            graphs.replays[self.name] = graphs.replays.get(self.name, 0) + 1
            return self.fn(*args)

    for attr, value in (("CapturedStep", Fake), ("_check_device", lambda name, leaves: None),
                        ("_steps", {}), ("_seen", set()), ("_graphs_by_name", {}),
                        ("_key_locks", {}), ("captures", [])):
        monkeypatch.setattr(graphs, attr, value)
    graphs.reset_counts()
    return made, hold, release


def test_worker_captures_holding_the_step_lock(fake_captures):
    """The visual-loop worker's pattern: a thread that holds the pipeline's
    step lock (a plain Lock) captures its graph without taking the lock
    again (lock=None: taking it would deadlock), and while that capture is
    under way the main thread replays its own graph (a capture holds its
    key's lock only, not the step table's); a capture of the main thread
    then takes the step lock, so it waits for the worker's step to end."""
    made, hold, release = fake_captures
    step_lock = threading.Lock()
    x = torch.ones(3)
    for _ in range(2):  # the main thread's key: eager, then captured (with the lock)
        graphs.step("vil_frame", lambda a: a + 1, (x,), lock=step_lock)
    hold.add("vl_keyframe")
    errors, started = [], threading.Event()

    def worker():
        try:
            with step_lock:
                graphs.step("vl_keyframe", lambda a: a * 2, (x,))  # first call: eager
                started.set()
                out = graphs.step("vl_keyframe", lambda a: a * 2, (x,))  # captures
                assert torch.equal(out, x * 2)
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    assert started.wait(timeout=20.0)
    deadline = time.monotonic() + 20.0
    while ("vl_keyframe", None) not in made and time.monotonic() < deadline:
        time.sleep(0.01)
    replayed = []
    main = threading.Thread(target=lambda: replayed.append(
        graphs.step("vil_frame", lambda a: a + 1, (x,), lock=step_lock)))
    main.start()
    main.join(timeout=10.0)
    assert not main.is_alive() and torch.equal(replayed[0], x + 1)  # replayed meanwhile
    assert t.is_alive()  # the worker's capture is still under way
    release.set()
    t.join(timeout=20.0)
    assert not t.is_alive() and not errors, errors
    assert made == [("vil_frame", step_lock), ("vl_keyframe", None)]
    assert graphs.replays == {"vil_frame": 2, "vl_keyframe": 1}
    assert not step_lock.locked()


def test_capture_of_a_key_waits_for_its_own_capture_only(fake_captures):
    """Two threads calling one key at its second call: one captures, the
    other waits for that capture and replays it (no second capture); a
    capture that raises leaves the key without a graph and raises."""
    made, hold, release = fake_captures
    x = torch.ones(2)
    graphs.step("k", lambda a: a - 1, (x,))
    hold.add("k")
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(graphs.step("k", lambda a: a - 1, (x,))))
          for _ in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.2)
    release.set()
    for t in ts:
        t.join(timeout=20.0)
    assert [n for n, _ in made] == ["k"] and len(outs) == 2
    assert all(torch.equal(o, x - 1) for o in outs) and graphs.replays == {"k": 2}

    def broken(name, fn, args, lock=None):
        raise RuntimeError("capture failed")

    graphs.step("bad", lambda a: a, (x,))
    graphs.CapturedStep = broken
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.step("bad", lambda a: a, (x,))
    assert not any(k[0] == "bad" for k in graphs._steps)
    assert graphs._graphs_by_name.get("bad", 0) == 0


def test_failed_capture_frees_its_graph_slot(fake_captures, monkeypatch):
    """A capture that raises leaves the name's count of graphs as it was:
    with one graph allowed a name, another key of that name still captures
    after the failure (and the failed key raises again, never running its
    body in place of a graph)."""
    made, _, _ = fake_captures
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 1)
    fake = graphs.CapturedStep

    def broken(name, fn, args, lock=None):
        raise RuntimeError("capture failed")

    x, y = torch.ones(2), torch.ones(3)
    graphs.step("n", lambda a: a + 1, (x,))
    monkeypatch.setattr(graphs, "CapturedStep", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.step("n", lambda a: a + 1, (x,))
    assert graphs._graphs_by_name.get("n", 0) == 0
    monkeypatch.setattr(graphs, "CapturedStep", fake)
    graphs.step("n", lambda a: a + 1, (y,))
    assert torch.equal(graphs.step("n", lambda a: a + 1, (y,)), y + 1)
    assert made == [("n", None)] and graphs._graphs_by_name == {"n": 1}
    assert graphs.replays == {"n": 1}
