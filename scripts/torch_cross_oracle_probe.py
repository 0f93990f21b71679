"""pytest plugin: the CPU float32 oracle of the card test
tests/test_torch_port_cuda.py::test_gram_mvm_gradients_match_cpu[cross],
instrumented after the file's earlier tests have run in the process.

    for i in $(seq 15); do for e in "" MKL_CBWR=COMPATIBLE; do
      env $e CROSS_TAG=$i$e PYTHONPATH=scripts python -m pytest --noconftest \
        -p torch_cross_oracle_probe -m cuda tests/test_torch_port_cuda.py -q
    done; done

Appends one JSON line a run to rpagp_torch/_build/cross_probe.jsonl (or
$CROSS_LOG): the test's outcome; for every float32 CPU call of
`gram_mvm_plain` / `gram_mvm_bwd_plain` inside the test (a tree whose
test computes its oracle in float32), the inputs' and outputs' data
pointers mod 64 bytes and each output's rel error against the same call
in float64, Gm = G V^T included; and, after the test, the float32 oracle's
gradients recomputed on the test's inputs, numpy-backed and as
torch-allocated copies, against float64 (rel per gradient), with the
inputs' alignments."""
import json
import os

import pytest
import torch

from rpagp_torch.ops import cuda_gram as cg

LOG = os.environ.get("CROSS_LOG", "rpagp_torch/_build/cross_probe.jsonl")
TAG = os.environ.get("CROSS_TAG", "")
rec = None
orig_fwd, orig_bwd = cg.gram_mvm_plain, cg.gram_mvm_bwd_plain


def _a(x):
    return x.data_ptr() % 64


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def fwd(z1, z2, w, V, base="rbf"):
    out = orig_fwd(z1, z2, w, V, base)
    if rec is not None and z1.device.type == "cpu" and z1.dtype == torch.float32:
        ref = orig_fwd(*(x.double() for x in (z1, z2, w, V)), base)
        rec["calls"].append({"fn": "fwd", "align": [_a(x) for x in (z1, z2, w, V)],
                             "out": _a(out), "rel": _rel(out, ref)})
    return out


def bwd(z1, z2, w, V, G, base="rbf"):
    if not (rec is not None and z1.device.type == "cpu" and z1.dtype == torch.float32):
        return orig_bwd(z1, z2, w, V, G, base)
    dz = torch.empty_like(z1)
    dw = torch.zeros_like(w)
    rows = cg._plain_rows(z1, z2)
    info = {"fn": "bwd", "align": [_a(x) for x in (z1, z2, w, V, G)], "Gm": []}
    for s in range(0, z1.shape[0], rows):
        Gm = (G[s:s + rows] @ V.T)[:, :, None]
        Gm64 = G[s:s + rows].double() @ V.double().T
        info["Gm"].append([_a(Gm), _rel(Gm[:, :, 0], Gm64)])
        d = z1[s:s + rows, None, :] - z2[None, :, :]
        dz[s:s + rows] = w * torch.sum(Gm * cg.k1d_grad_tile(base, d), dim=1)
        dw += torch.sum(Gm * cg.k1d_tile(base, d), dim=(0, 1))
    rz, rw = orig_bwd(*(x.double() for x in (z1, z2, w, V, G)), base)
    info["dz"], info["dw"] = _rel(dz, rz), _rel(dw, rw)
    rec["calls"].append(info)
    return dz, dw


def _cpu_grads(arrs, dtype):
    ts = [a.detach().to(dtype).requires_grad_(True) if dtype != torch.float32
          else a.detach().requires_grad_(True) for a in arrs]
    torch.sum(torch.sin(cg.projected_gram_mvm(ts[0], ts[1], ts[2], ts[3],
                                              "matern32"))).backward()
    return [t.grad.double() for t in ts]


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    global rec
    if "gradients_match_cpu[cross]" not in item.nodeid:
        yield
        return
    rec = {"tag": TAG, "threads": torch.get_num_threads(), "calls": [],
           "mkl_cbwr": os.environ.get("MKL_CBWR", "")}
    cg.gram_mvm_plain, cg.gram_mvm_bwd_plain = fwd, bwd
    try:
        outcome = yield
        rec["outcome"] = "failed" if outcome.excinfo else "passed"
    finally:
        cg.gram_mvm_plain, cg.gram_mvm_bwd_plain = orig_fwd, orig_bwd
    r, rec = rec, None
    # the same oracle again in this process: numpy-backed, and torch-allocated copies
    arrs = item.module._gram_case(300, 250, 3, 7, seed=1, dev="cpu")[:4]
    ref = _cpu_grads(arrs, torch.float64)
    r["again_numpy"] = [_rel(a, b) for a, b in zip(_cpu_grads(arrs, torch.float32), ref)]
    r["again_numpy_align"] = [_a(x) for x in arrs]
    cl = [a.clone() for a in arrs]
    r["again_clone"] = [_rel(a, b) for a, b in zip(_cpu_grads(cl, torch.float32), ref)]
    r["again_clone_align"] = [_a(x) for x in cl]
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    with open(LOG, "a") as f:
        f.write(json.dumps(r) + "\n")
