"""Operation count of one env of K5, the fused tick (ops/cuda_tick.py).

`fused_qdd_ops(tick, K)` walks the reference kernel body
(rmp_tpu/ops/pallas_tick.py `_make_kernel`) with its constant folding and
counts what it computes. A value is a Python float while it is a constant of
the model, and VAR once it depends on the env. As in pallas_fk._add/_mul, a
product with an exact 0 or 1 and a sum with an exact 0 cost nothing, and
constants combine for free; so the FK recursion pays nothing for the rigid
last row [0 0 0 1], the zeros and ones of T_constant or the sparse
generators E. Every other add, mul, div, neg, abs, sign, sqrt, exp, sin,
cos, logistic, max, min, compare, logical and or select is one operation.
The count equals the arithmetic equations of the body's jaxpr
(tests/test_torch_tick.py).

It returns (total, mirrored). `mirrored` are the operations on A's upper
triangle (each contribution added twice, the velocity cap's weight added
to every entry) and the symmetrisation 0.5 (A + Aᵀ) before the Cholesky:
A is symmetric by construction, so a solve that accumulates the lower
triangle only does total - mirrored, the count that chip_smoke.py's bound
uses.
"""
from __future__ import annotations

import functools

from rmp_tpu_torch.models.urdf import FIXED, PRISMATIC, REVOLUTE, ROOT
from rmp_tpu_torch.ops import cuda_tick
from rmp_tpu_torch.ops.cuda_fk import ancestor_table

VAR = None              # an env-dependent value
_EPS_CONST = 1e-30      # pallas_fk._EPS_CONST: a constant this small is 0


def _zero(x) -> bool:
    return x is not VAR and abs(x) < _EPS_CONST


class _Count:
    def __init__(self):
        self.ops = 0

    def op(self, k: int = 1):
        """k operations whose result depends on the env."""
        self.ops += k
        return VAR

    def add(self, a, b):
        if _zero(a):
            return b
        if _zero(b):
            return a
        return a + b if a is not VAR and b is not VAR else self.op()

    def mul(self, a, b):
        if _zero(a) or _zero(b):
            return 0.0
        if a == 1.0:
            return b
        if b == 1.0:
            return a
        return a * b if a is not VAR and b is not VAR else self.op()

    def sum(self, terms):
        return functools.reduce(self.add, terms)

    def mm44(self, A, B):
        return [[self.sum(self.mul(A[i][k], B[k][j]) for k in range(4))
                 for j in range(4)] for i in range(4)]

    def madd44(self, A, B):
        return [[self.add(A[i][j], B[i][j]) for j in range(4)]
                for i in range(4)]

    def msub44(self, A, B):
        return [[self.add(A[i][j], self.mul(-1.0, B[i][j])) for j in range(4)]
                for i in range(4)]

    def scale44(self, s, A):
        return [[self.mul(s, A[i][j]) for j in range(4)] for i in range(4)]

    def rigid_inv(self, A):
        R = [[A[j][i] for j in range(3)] for i in range(3)]
        t = [self.sum(self.mul(-1.0, self.mul(R[i][k], A[k][3]))
                      for k in range(3)) for i in range(3)]
        return [R[0] + [t[0]], R[1] + [t[1]], R[2] + [t[2]],
                [0.0, 0.0, 0.0, 1.0]]

    def axis_rotation(self, axis):
        c, s, one_c = self.op(), self.op(), self.op()    # cos, sin, 1 - cos
        x, y, z = (float(a) for a in axis)
        add, mul = self.add, self.mul
        return [
            [add(c, mul(x * x, one_c)), add(mul(x * y, one_c), mul(-z, s)),
             add(mul(x * z, one_c), mul(y, s)), 0.0],
            [add(mul(x * y, one_c), mul(z, s)), add(c, mul(y * y, one_c)),
             add(mul(y * z, one_c), mul(-x, s)), 0.0],
            [add(mul(x * z, one_c), mul(-y, s)),
             add(mul(y * z, one_c), mul(x, s)), add(c, mul(z * z, one_c)),
             0.0],
            [0.0, 0.0, 0.0, 1.0]]

    def transform_point(self, T, p):
        return [self.add(self.sum(self.mul(T[i][k], p[k]) for k in range(3)),
                         T[i][3]) for i in range(3)]

    def dot3(self, a, b):
        return self.sum(self.mul(a[i], b[i]) for i in range(3))


def _const44(M):
    return [[float(M[i][j]) for j in range(4)] for i in range(4)]


def _generator(model, i):
    x, y, z = (float(a) for a in model.axis[i])
    E = [[0.0] * 4 for _ in range(4)]
    if model.joint_type[i] == REVOLUTE:
        E[0][1], E[0][2] = -z, y
        E[1][0], E[1][2] = z, -x
        E[2][0], E[2][1] = -y, x
    else:
        E[0][3], E[1][3], E[2][3] = x, y, z
    return E


def fused_qdd_ops(tick, K: int) -> tuple[int, int]:
    """(total, mirrored) operations of one env of K5 with K obstacles."""
    model = tick.model
    n, F = model.n_q, model.n_frames
    c = _Count()
    eye, zero44 = _const44([[float(i == j) for j in range(4)]
                            for i in range(4)]), [[0.0] * 4] * 4

    # ---- FK recursion --------------------------------------------------
    T, W, Wd, G = [None] * F, [None] * F, [None] * F, [None] * F
    for i in range(F):
        par, jt = model.parent[i], model.joint_type[i]
        T_par = eye if par == ROOT else T[par]
        W_par = zero44 if par == ROOT else W[par]
        Wd_par = zero44 if par == ROOT else Wd[par]
        A = c.mm44(T_par, _const44(model.T_constant[i]))
        if jt == FIXED:
            T_var = eye
        elif jt == REVOLUTE:
            T_var = c.axis_rotation(model.axis[i])
        else:
            assert jt == PRISMATIC
            T_var = [row[:] for row in eye]
            for r in range(3):
                T_var[r][3] = c.mul(float(model.axis[i][r]), VAR)
        T[i] = c.mm44(A, T_var)
        if jt == FIXED:
            W[i], Wd[i] = W_par, Wd_par
        else:
            G[i] = c.mm44(c.mm44(A, _generator(model, i)), c.rigid_inv(A))
            W[i] = c.madd44(W_par, c.scale44(VAR, G[i]))
            comm = c.msub44(c.mm44(W_par, G[i]), c.mm44(G[i], W_par))
            Wd[i] = c.madd44(Wd_par, c.scale44(VAR, comm))

    anc = ancestor_table(model)

    def point_derivs(f):
        p_h = c.transform_point(T[f], [0.0, 0.0, 0.0]) + [1.0]
        acc = c.madd44(Wd[f], c.mm44(W[f], W[f]))
        pd = [c.sum(c.mul(W[f][i][k], p_h[k]) for k in range(4))
              for i in range(3)]
        cv = [c.sum(c.mul(acc[i][k], p_h[k]) for k in range(4))
              for i in range(3)]
        J = [[c.sum(c.mul(G[anc[f, m]][i][k], p_h[k]) for k in range(4))
              if anc[f, m] >= 0 else 0.0 for m in range(n)] for i in range(3)]
        return p_h[:3], pd, J, cv

    # ---- accumulators: each op on the upper triangle is mirrored -------
    A_sys = [[VAR if i == j else 0.0 for j in range(n)] for i in range(n)]
    f_sys = [0.0] * n
    mirrored = 0

    def acc(i, j, x):
        nonlocal mirrored
        before = c.ops
        A_sys[i][j] = c.add(A_sys[i][j], x)
        if j > i:
            mirrored += c.ops - before

    # ---- attractor ------------------------------------------------------
    x, _, Jx, cx = point_derivs(tick.ee_frame)
    delta = [c.add(VAR, c.mul(-1.0, x[i])) for i in range(3)]
    c.dot3(delta, delta)
    # dn (max, sqrt), soft, dhat (3), a − d ẋ (5 x 3), alpha (6), boost (7),
    # M (8 x 9)
    c.op(2 + 1 + 3 + 15 + 6 + 7 + 72)
    amc = [c.add(VAR, c.mul(-1.0, cx[i])) for i in range(3)]
    u = [c.sum(c.mul(VAR, amc[k]) for k in range(3)) for _ in range(3)]
    W_att = [[c.sum(c.mul(VAR, Jx[k][j]) for k in range(3))
              for j in range(n)] for _ in range(3)]
    for jc in range(n):
        f_sys[jc] = c.add(f_sys[jc],
                          c.sum(c.mul(Jx[k][jc], u[k]) for k in range(3)))
        for ic in range(jc, n):
            contrib = c.sum(c.mul(Jx[k][ic], W_att[k][jc]) for k in range(3))
            acc(ic, jc, contrib)
            if ic != jc:
                acc(jc, ic, contrib)

    # ---- identity-space leaves -------------------------------------------
    for kind, o in tick.identity:
        if kind == cuda_tick.VELCAP:
            wgt = float(tick.consts[o + 3])
            c.op(15 * n)            # dv, a, the where, ratio, m per motor
            s_all = c.sum([VAR] * n)
            for i in range(n):
                c.mul(wgt, s_all)
                f_sys[i] = c.add(f_sys[i], c.op(3))   # m − w, ·a, +
                acc(i, i, c.op())                     # m − w
                for j in range(n):
                    acc(i, j, wgt)
        elif kind == cuda_tick.DAMPING:
            c.sum(c.mul(VAR, VAR) for _ in range(n))
            c.op(4)                 # max, sqrt, e = s |q̇| + i
            for j in range(n):
                f_sys[j] = c.add(f_sys[j], c.op(3))
                acc(j, j, VAR)
        else:
            xs = [c.add(VAR, -float(g)) for g in tick.consts[o + 4:o + 4 + n]]
            c.sum(c.mul(v, v) for v in xs)
            c.op(2)                 # max, sqrt
            for j in range(n):
                c.op(2 + 6 + 2)     # xhat, the where, a − d q̇
                f_sys[j] = c.add(f_sys[j], c.op())
                acc(j, j, VAR)

    # ---- grouped obstacle avoidance ---------------------------------------
    for li, fr in enumerate(tick.col_frames):
        _, _, Jo, co = point_derivs(fr)
        cap = [float(v) for v in tick.caps[li]]
        a0 = c.transform_point(T[fr], cap[0:3])
        a1 = c.transform_point(T[fr], cap[3:6])
        for _ in range(K):
            d1 = [c.add(a1[i], c.mul(-1.0, a0[i])) for i in range(3)]
            d2 = [c.add(VAR, c.mul(-1.0, VAR)) for _ in range(3)]
            r = [c.add(a0[i], c.mul(-1.0, VAR)) for i in range(3)]
            for u_, v_ in ((d1, d1), (d2, d2), (d2, r), (d1, r), (d1, d2)):
                c.dot3(u_, v_)
            # clamped segment parameters (35); closest points, both
            # normalised directions and distances (50)
            c.op(35 + 50)
            Jd = [c.sum(c.mul(VAR, Jo[i][j]) for i in range(3))
                  for j in range(n)]
            c.op(5 + 5)             # ẋ_d, |ṗ|²
            c_lin = c.sum(c.mul(VAR, co[i]) for i in range(3))
            c.add(c_lin, c.op(3))
            c.op(33)                # the obstacle policy's a and m
            live = [j for j in range(n) if Jd[j] is VAR]
            for jc in live:
                c.op()              # m J_d
            for jc in live:
                f_sys[jc] = c.add(f_sys[jc], c.op(2))
                for ic in live:
                    if ic < jc:
                        continue
                    contrib = c.op()
                    acc(ic, jc, contrib)
                    if ic != jc:
                        acc(jc, ic, contrib)

    # ---- symmetrise, Cholesky, two triangular solves ----------------------
    before = c.ops
    for i in range(n):
        for j in range(n):
            if A_sys[i][j] is VAR or A_sys[j][i] is VAR:
                c.mul(0.5, c.add(A_sys[i][j], A_sys[j][i]))
    mirrored += c.ops - before
    for j in range(n):
        c.op(2 * j + 3 + (n - j - 1) * (2 * j + 1))
    c.op(2 * sum(2 * i + 1 for i in range(n)))
    return c.ops, mirrored
