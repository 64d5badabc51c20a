"""The thin launch path (``ops/cuda/launch.py``) and what this slice built
on it, checked on the CPU:

- the marshalling of every C signature in ``build.SIGNATURES``, against a
  stub library compiled with g++ from those signatures in a temporary
  directory: it records the pointers, ints and floats it is given (null
  for None) and the stream, last; the count moves by one a launch and not
  at all when the C function returns an error;
- pass 2's outputs, views of one allocation, keep the shapes, order and
  independence of separate tensors, for every form the wrapper takes;
- ``probe_gather_plain`` against the reference's row gather
  (``ops/structure.py _window_gather``: ids clipped into [0, nb), then
  the rows), for widths that are not a multiple of 4 and ids out of range;
- ``roofline.measure_launch`` reports the eager and the graphed cost, and
  the graphed measurement refuses without a card;
- chip_smoke.py's new pieces that need no card: the NaN plantings of p2p
  and gravity_fused, and the probe turn it runs in another checkout.
"""

import ast
import ctypes
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu.ops import structure as ref_structure
from planetmodel_sph_tpu_torch.ops.cuda import build, launch, probes
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
from planetmodel_sph_tpu_torch.tools import roofline
from test_torch_groups2 import B, _case, _cols, _grav_inputs, _t
from test_torch_groups2_modes import PASS2_CASES, _pass2_inputs
from test_torch_smoke_report import cs

_C_TYPES = {"p": "void*", "i": "int", "f": "float"}


def _stub_source():
    """One C entry point per signature that records its arguments."""
    lines = ['extern "C" {', "long long vals[96];", "double fvals[96];",
             "int count;", "int rc_next;",
             "void stub_read(long long* v, double* f, int* n) {",
             "  for (int k = 0; k < count; ++k) { v[k] = vals[k]; "
             "f[k] = fvals[k]; }",
             "  *n = count;", "}",
             "void stub_set_rc(int rc) { rc_next = rc; }"]
    for name, sig in build.SIGNATURES.items():
        params = ", ".join(f"{_C_TYPES[c]} a{k}" for k, c in enumerate(sig))
        lines.append(f"int psph_{name}({params}) {{")
        lines.append(f"  count = {len(sig)};")
        for k, c in enumerate(sig):
            if c == "f":
                lines.append(f"  fvals[{k}] = a{k}; vals[{k}] = 0;")
            elif c == "p":
                lines.append(f"  vals[{k}] = (long long)a{k}; "
                             f"fvals[{k}] = 0;")
            else:
                lines.append(f"  vals[{k}] = a{k}; fvals[{k}] = 0;")
        lines += ["  return rc_next;", "}"]
    lines.append("}")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    d = tmp_path_factory.mktemp("stub")
    src, so = d / "stub.cc", d / "libstub.so"
    src.write_text(_stub_source())
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.stub_set_rc.argtypes = [ctypes.c_int]

    def read():
        v = (ctypes.c_longlong * 96)()
        f = (ctypes.c_double * 96)()
        n = ctypes.c_int()
        lib.stub_read(v, f, ctypes.byref(n))
        return list(v[:n.value]), list(f[:n.value])
    return str(so), lib, read


def _arguments(sig, seed):
    """Arguments for a signature (its stream left out): a CPU tensor for a
    pointer, None for every third one, distinct ints and floats."""
    rng = np.random.default_rng(seed)
    args = []
    for k, c in enumerate(sig[:-1]):
        if c == "p":
            args.append(None if k % 3 == 2 and k else
                        torch.zeros(int(rng.integers(1, 9))))
        elif c == "i":
            args.append(int(rng.integers(-2**31, 2**31)))
        else:
            args.append(float(np.float32(rng.normal() * 1e3)))
    return args


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_launch_marshals_every_signature(name, stub, monkeypatch):
    path, lib, read = stub
    sig = build.SIGNATURES[name]
    assert sig[-1] == "p"                       # the stream, last
    args = _arguments(sig, len(name))
    if not isinstance(args[0], torch.Tensor):
        args[0] = torch.zeros(2)
    stream = 0x5EED0 + len(name)
    seen = []
    monkeypatch.setattr(launch, "_RAW_STREAM",
                        lambda dev: seen.append(dev) or stream)
    launch.reset_launches()
    lib.stub_set_rc(0)
    with build.library(name, path):
        launch.launch(name, args)
    vals, fvals = read()
    assert len(vals) == len(sig)
    assert seen == [args[0].get_device()]       # read at the launch
    for k, (c, a) in enumerate(zip(sig, args)):
        if c == "p":
            assert vals[k] == (0 if a is None else a.data_ptr()), k
        elif c == "i":
            assert vals[k] == a, k
        else:
            assert fvals[k] == a, k
    assert vals[-1] == stream
    assert launch.LAUNCHES[name] == 1
    assert sum(launch.LAUNCHES.values()) == 1


def test_launch_raises_on_an_error_and_counts_nothing(stub, monkeypatch):
    path, lib, _ = stub
    monkeypatch.setattr(launch, "_RAW_STREAM", lambda dev: 1)
    launch.reset_launches()
    lib.stub_set_rc(700)
    try:
        with build.library("probe_launch", path):
            with pytest.raises(RuntimeError, match="error 700"):
                launch.launch("probe_launch",
                              [torch.zeros(4), torch.zeros(4), 4])
    finally:
        lib.stub_set_rc(0)
    assert launch.LAUNCHES["probe_launch"] == 0


def test_launch_needs_a_cuda_build(monkeypatch, stub):
    monkeypatch.setattr(launch, "_RAW_STREAM", None)
    with build.library("probe_launch", stub[0]):
        with pytest.raises(RuntimeError, match="no CUDA"):
            launch.launch("probe_launch", [torch.zeros(1)] * 2 + [1])


def test_checks_read_each_tensor_once_and_still_raise():
    x = torch.zeros((4, 3))
    launch.need("k", "x", x, (4, 3))
    launch.need("k", "x", x, [4, 3])            # any sequence of sizes
    launch.need("k", "x", x, x.shape)
    with pytest.raises(ValueError, match="shape"):
        launch.need("k", "x", x, (3, 4))
    with pytest.raises(TypeError, match="int32"):
        launch.need("k", "x", x, (4, 3), torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        launch.need("k", "x", x.t(), (3, 4))
    assert launch.is_cuda("k", [x, torch.zeros(2)]) is False
    with pytest.raises(ValueError, match="tensors on"):
        launch.is_cuda("k", [x, torch.zeros(2, device="meta")])
    with pytest.raises(ValueError, match="unsupported device"):
        launch.is_cuda("k", [torch.zeros(2, device="meta")])


# the output pointers of psph_pass2: after 12 target columns, 13 source
# rows, 5 P2P rows, nv and nv2
PASS2_OUTS = slice(32, 48)


@pytest.mark.parametrize("case", sorted(PASS2_CASES))
def test_pass2_outputs_are_independent_views_in_order(case, monkeypatch):
    f = PASS2_CASES[case]
    nv, tgt, src, pkw = _pass2_inputs(3, f["mode"], f["av"], f["balsara"],
                                      f["merged"], f["receiver"],
                                      energy=f["energy"])
    kw = dict(mode=f["mode"], av=f["av"], balsara=f["balsara"],
              energy=f["energy"], grav=f["grav"], sign_bug=f["sign_bug"],
              receiver_soft=f["receiver"])
    if f["merged"]:
        kw.update(nv_p2p=torch.from_numpy(pkw["nv_p2p"]),
                  p2p_rows=_t(pkw["p2p_rows"]))
    seen = []
    monkeypatch.setattr(gk2, "_is_cuda", lambda *_: True)
    monkeypatch.setattr(gk2, "_launch", lambda n, a: seen.append(a))
    out = gk2.pass2(torch.from_numpy(nv), _t(tgt), _t(src), b=B, **kw)
    (args,) = seen
    ptrs = args[PASS2_OUTS]
    passed = [a for a in ptrs if a is not None]
    # every output the flags ask for, in the C interface's order
    n_f = 3 + 3 * f["av"] + 4 * f["balsara"] + f["energy"] + 4 * f["grav"]
    assert len(out) == len(passed) == n_f + f["grav"]
    assert all(o is p for o, p in zip(out, passed))
    # the same null pointers as the flags switch off
    on = [True] * 3 + [f["av"]] * 3 + [f["balsara"]] * 4 + [f["energy"]] \
        + [f["grav"]] * 5
    assert [a is not None for a in ptrs] == on
    g = nv.shape[0]
    for k, o in enumerate(out):
        assert o.shape == (g * B, 1) and o.is_contiguous()
        assert o.dtype == (torch.int32 if f["grav"] and k == len(out) - 1
                           else torch.float32)
    # disjoint memory: writing one output leaves the others as they were
    spans = sorted((o.data_ptr(), o.data_ptr() + o.numel() * 4)
                   for o in out)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for o in out:
        o.zero_()
    out[0].fill_(7)
    assert all(int(o.count_nonzero()) == 0 for o in out[1:])


@pytest.mark.parametrize("nb,bsz,c,g,w", [(13, 7, 3, 5, 4), (9, 5, 1, 3, 6),
                                          (20, 64, 7, 4, 3)],
                         ids=["width21", "width5", "width448"])
def test_probe_gather_plain_is_the_window_gather(nb, bsz, c, g, w):
    rng = np.random.default_rng(nb)
    cols = [rng.normal(size=nb * bsz).astype(np.float32) for _ in range(c)]
    idx = rng.integers(-3, nb + 3, (g, w)).astype(np.int32)
    idx[0, :2] = (-1, nb)                     # padding and past the end
    ref = ref_structure._window_gather([jnp.asarray(x) for x in cols],
                                       jnp.asarray(idx), nb, bsz, 8)
    packed = torch.from_numpy(np.concatenate(
        [x.reshape(nb, bsz) for x in cols], axis=1))
    out = probes.probe_gather_plain(packed, torch.from_numpy(idx))
    assert out.shape == (g, w, c * bsz)
    for k, r in enumerate(ref):
        np.testing.assert_array_equal(
            out[:, :, k * bsz:(k + 1) * bsz].reshape(g, w * bsz).numpy(),
            np.asarray(r)[:, :w * bsz])


def test_measure_launch_reports_eager_and_graphed():
    rep = roofline.measure_launch(k=4, device="cpu")
    assert set(rep) == {"eager_s", "graph_s"}
    assert rep["eager_s"] > 0
    assert rep["graph_s"] is None               # no CUDA graph on the CPU
    with pytest.raises(RuntimeError, match="needs a card"):
        roofline.graph_launch(k=4, device="cpu")


def test_graphed_launch_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: roofline.graph_launch(k=4),
                 lambda: roofline.measure_launch(k=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_nan_plantings_cover_p2p_and_gravity_fused():
    """On the CPU the wrappers run their plain versions, so the check
    passes; p2p's planted m and a dead slot's x reach an output, gravity's
    ring m is masked out by m > 0 in the plain version as in the kernel."""
    nvp, ptgt, psrc = _case(4)
    a = (torch.from_numpy(nvp), tuple(_t(_cols(ptgt))), tuple(_t(psrc)))
    msg, reached = cs.nan_agreement("p2p", a, dict(b=B, receiver_soft=False))
    assert msg is None and reached == {"m": True, "ih": reached["ih"],
                                       "dead x": True,
                                       "dead ih": reached["dead ih"]}
    nv, tgt, ring, far, accept = _grav_inputs(2, 10)
    a = (torch.from_numpy(nv), _t(tgt), _t(ring), _t(far),
         torch.from_numpy(accept))
    msg, reached = cs.nan_agreement("gravity_fused", a, dict(b=B))
    assert msg is None and set(reached) == {"m", "ih"}
    assert not any(reached.values())
    assert set(cs.NAN_CHECKED) == {"pass1_gradh", "pass1_sym", "pass2",
                                   "p2p", "gravity_fused", "filter_sph"}


def test_probe_turn_is_a_program_of_the_two_probes():
    tree = ast.parse(cs.PROBE_TURN)
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func,
                                                        ast.Attribute)}
    assert {"probe_gather", "dumps"} <= called
    assert "probes.probe_launch" in cs.PROBE_TURN
    assert f"{cs.GATHER_NB}, {cs.GATHER_W}" in cs.PROBE_TURN


def test_a_time_not_measured_is_said_so():
    """chip_smoke.device_ms returns None for a trace with no kernel in it
    (never 0), and the report prints that as "not measured"."""
    assert cs.fmt_ms(None) == "not measured"
    assert cs.fmt_ms(0.123456) == "0.1235"
    assert cs.fmt_ms(0.0011456, 5) == "0.00115"
