"""The plain reference against the port's plain CPU path, at tiny n:
the SKI operator, and the SKI + BBMM estimate and its gradient."""

import torch

from gpbench.reference import check, common, data


def _problem(seed=5, n=2500, d=11, J=4, m=32):
    X, y = data.synthetic(n, d, seed, "cpu")
    tr, te = data.fold_indices(n, 10, seed, "cpu")[0]
    s = data.zscored_split(X, y, tr, te)
    return s, data.gaussian_projection(d, J, seed), J, m


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    a = data.synthetic(1000, 11, 2**31 + 5, "cpu")
    b = data.synthetic(1000, 11, 2**31 + 5, "cpu")
    c = data.synthetic(1000, 11, 2**31 + 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    folds = data.fold_indices(1003, 10, 3, "cpu")
    assert len({f[0].numel() for f in folds}) == 1  # one train shape
    tests = torch.cat([f[1] for f in folds]).sort().values
    assert torch.equal(tests, torch.arange(1003))  # the folds partition


def test_projection_is_the_ports_draw():
    from rpagp_torch.projections import gen_rp

    got = data.gaussian_projection(11, 20, 77)
    want = gen_rp(11, 20, "gaussian", generator=torch.Generator()
                  .manual_seed(77))
    assert torch.equal(got, want)


def test_bbmm_estimate_matches_the_port():
    """The SKI + BBMM reference against the port's plain CPU path on the
    same probe normals: the first step's loss and gradient."""
    from gpbench import drive, harness
    from gpbench.reference import ski_bbmm

    c = harness.load_cell("he_j20_bbmm.train", {
        "data": {"n": 3000}, "kernel": {"J": 4, "grid_size": 32}})
    tr = drive.make(c.cfg, c.mix, 7, "cpu")
    tr.setup()
    spec = tr.spec
    op = ski_bbmm.Operator(tr.x, tr.proj, 32, torch.float64)
    (es, eb), = ski_bbmm.probe_normals(8, op.n, spec.precond_rank,
                                       spec.num_probes, 1, "cpu")
    loss, grad = ski_bbmm.loss_and_grad(
        op, common.zero_params(4, torch.float64, "cpu"), tr.y, es, eb,
        spec.precond_rank, spec.cg_max_iters, spec.cg_tol)
    rec = tr.record
    assert abs(rec["losses"][0] - float(loss)) < 1e-5 * abs(float(loss))
    port = torch.cat([rec["grad"][k].double().reshape(-1) for k in grad])
    want = torch.cat([g.reshape(-1) for g in grad.values()])
    assert _rel(port, want) < 1e-2  # CG's 20 float32 iterations


def test_kernel_mvm_matches_the_ports_ski_operator():
    """The reference's K V against the port's SKI MVM (K2, the Toeplitz
    product, K3) on the same points and V, at the initial
    hyperparameters."""
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import ski
    from rpagp_torch.utils.config import experiment_spec_from_dict

    from gpbench.reference import ski_bbmm

    s, proj, J, m = _problem(seed=9)
    spec = experiment_spec_from_dict({"kernel": {
        "type": "projection", "J": J, "d": 1, "base": "rbf", "ski": True,
        "grid_size": m}}).model
    x = s["train_x"]
    params, buffers = exact_gp.init_model(spec, x.shape[1], proj=proj,
                                          device="cpu")
    state = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"],
                          x, m)
    V = torch.randn(x.shape[0], 3, generator=torch.Generator().manual_seed(
        1))
    got = ski.ski_mvm(spec.kernel, params["kernel"], state, V)
    op = ski_bbmm.Operator(x, proj, m, torch.float64)
    want = op.kernel_mvm(common.zero_params(J, torch.float64, "cpu"),
                         V.double())
    assert check.columns(got, want) < 1e-4
    # half of the rows left out reads far above the limit
    half = V.clone()
    half[x.shape[0] // 2:] = 0
    got_half = ski.ski_mvm(spec.kernel, params["kernel"], state, 2 * half)
    assert check.columns(got_half, want) > 0.3
