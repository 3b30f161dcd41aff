"""Vertical advection in plain PyTorch, written from the GTScript definition in
perfbench/programs/vadv.py: a Thomas solve down and up each column, the
columns side by side.

``step`` applies it once over the configuration's domain (from ``origin``;
``wcon`` is read one point further in I) and returns ``utens_stage``, its
points outside the domain as they were.
"""


def step(fields: dict, config: dict) -> dict:
    """One application; returns the written field as a new tensor."""
    (oi, oj, ok), (ni, nj, nk) = config["origin"], config["domain"]
    bet_m, bet_p = config["externals"]["BET_M"], config["externals"]["BET_P"]
    dtr = config["scalars"]["dtr_stage"]
    box = (slice(oi, oi + ni), slice(oj, oj + nj))
    stage = fields["utens_stage"]
    w0 = fields["wcon"][box]
    w1 = fields["wcon"][oi + 1:oi + ni + 1, oj:oj + nj]
    u, pos, ten, st = (fields[n][box] for n in ("u_stage", "u_pos", "utens", "utens_stage"))
    ccol, dcol = [None] * nk, [None] * nk
    for k in range(ok, ok + nk):
        rhs = dtr * pos[..., k] + ten[..., k] + st[..., k]
        if k == ok:
            gcv = 0.25 * (w1[..., k + 1] + w0[..., k + 1])
            cs = gcv * bet_m
            c = gcv * bet_p
            bcol = dtr - c
            d = rhs + -cs * (u[..., k + 1] - u[..., k])
            divided = 1.0 / bcol
            ccol[k - ok], dcol[k - ok] = c * divided, d * divided
            continue
        gav = -0.25 * (w1[..., k] + w0[..., k])
        as_ = gav * bet_m
        acol = gav * bet_p
        if k < ok + nk - 1:
            gcv = 0.25 * (w1[..., k + 1] + w0[..., k + 1])
            cs = gcv * bet_m
            c = gcv * bet_p
            bcol = dtr - acol - c
            corr = -as_ * (u[..., k - 1] - u[..., k]) - cs * (u[..., k + 1] - u[..., k])
        else:
            bcol = dtr - acol
            corr = -as_ * (u[..., k - 1] - u[..., k])
        d = rhs + corr
        divided = 1.0 / (bcol - ccol[k - ok - 1] * acol)
        if k < ok + nk - 1:
            ccol[k - ok] = c * divided
        dcol[k - ok] = (d - dcol[k - ok - 1] * acol) * divided
    new = stage.clone()
    datacol = dcol[nk - 1]
    new[box][..., ok + nk - 1] = dtr * (datacol - pos[..., ok + nk - 1])
    for k in range(nk - 2, -1, -1):
        datacol = dcol[k] - ccol[k] * datacol
        new[box][..., ok + k] = dtr * (datacol - pos[..., ok + k])
    return {"utens_stage": new}
