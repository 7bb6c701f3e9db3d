"""The sparse VI solver over stereo rows, from the reference's own state
(tests/stereo_inertial_long_rig.py, state "loop": a stereo-inertial map
past VIBA2, just before its first loop): each side builds the whole
temporal chain's FullInertialBA problem with the map-scale capacities of
the sparse route (`_build_vi_problem` as `_full_inertial_ba` calls it for a
chain over vi_full_kf_cap keyframes, whatever the chain's length here) and
solves it with its own `sparse_vi_ba` for FullInertialBA(7)'s iterations.
Gates: the two problems equal (the stereo rows, their right coordinates and
everything else: tolerance exact) and the solutions within
tests/test_torch_vi_ba.py's bars (body states 1e-4, landmarks 1e-3).
"""

import numpy as np
import pytest
import torch

from stereo_inertial_long_rig import scene_and_frames

TOL_STATE = 1e-4
TOL_LM = 1e-3
ITERS = 7
FIELDS = ("Rwb", "twb", "vel", "bg", "ba", "kf_valid", "kf_fixed", "Xw", "lm_valid", "obs_kf", "obs_lm", "obs_uvr",
          "obs_sigma2", "obs_stereo", "obs_valid", "edge_i", "edge_j", "edge_valid")


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def solved():
    from long_loop_rig import load_states
    from orbslam3_cpp_fork_tpu.optim.sparse_ba import sparse_vi_ba as ref_solve
    from orbslam3_cpp_fork_tpu_torch.optim.sparse_ba import sparse_vi_ba as port_solve
    from stereo_inertial_long_rig import STATES, loaded

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        S = load_states(STATES)[0]["loop"]
        scene = scene_and_frames(render=False)[0]
        out = {}
        for impl, solve in (("reference", ref_solve), ("port", port_solve)):
            trk = loaded(impl, scene, S)
            cfg = trk.cfg
            chain = trk.map.temporal_window(S["call"]["k"], 10**6)[::-1]
            K_cap = min(-(-(len(chain) + cfg.ba_fixed_cap) // 64) * 64, cfg.map_cfg.max_keyframes + cfg.ba_fixed_cap)
            built = trk._build_vi_problem(chain, K_cap=K_cap, obs_cap=cfg.gba_obs_cap,
                                          lm_cap=cfg.map_cfg.max_landmarks)
            prob, kfs, lms = built[:3]
            res = solve(prob, iters=ITERS, gate_at=min(8, ITERS - 2))
            out[impl] = dict(prob=prob, n_kf=len(kfs), n_lm=len(lms), chain=len(chain), K_cap=K_cap,
                             res={f: _host(getattr(res, f)) for f in ("Rwb", "twb", "vel", "bg", "ba", "Xw", "cost")})
    finally:
        torch.set_num_threads(n)
    return out


def test_the_same_problem_with_stereo_rows(solved):
    a, b = solved["reference"]["prob"], solved["port"]["prob"]
    v, st = _host(a.obs_valid).astype(bool), _host(a.obs_stereo).astype(bool)
    print(f"\nthe whole chain: {solved['reference']['chain']} keyframes (K_cap {solved['reference']['K_cap']}), "
          f"{solved['reference']['n_lm']} landmarks, {int(v.sum())} rows, {int((v & st).sum())} of them stereo")
    assert (v & st).sum() > 0
    for f in FIELDS:
        assert np.array_equal(_host(getattr(a, f)), _host(getattr(b, f))), f"{f}: tolerance exact"
    for f in ("fx", "fy", "bf", "prior_kf", "prior_g", "prior_a"):
        assert float(getattr(a, f)) == float(getattr(b, f)), f


def test_sparse_vi_ba_agrees(solved):
    a, b = solved["reference"], solved["port"]
    n, m = a["n_kf"], a["n_lm"]
    assert (b["n_kf"], b["n_lm"]) == (n, m)
    for f in ("Rwb", "twb", "vel", "bg", "ba"):
        err = float(np.abs(b["res"][f][:n] - a["res"][f][:n]).max())
        print(f"\n{f}: max |port - reference| {err:.3e} over {n} keyframes (tolerance {TOL_STATE})")
        assert err <= TOL_STATE, f
    err = float(np.abs(b["res"]["Xw"][:m] - a["res"]["Xw"][:m]).max())
    print(f"\nXw: max |port - reference| {err:.3e} over {m} landmarks (tolerance {TOL_LM}); costs: reference "
          f"{np.asarray(a['res']['cost']).ravel()}, port {np.asarray(b['res']['cost']).ravel()}")
    assert err <= TOL_LM
