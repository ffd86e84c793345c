// Team G1 arithmetic: a team of lanes works on one Jacobian point over Fq
// together. K2's G1 ladder (bls381_g.cu g1_ladder_kernel) runs a warp a
// team on it, K2's segment sums (g1_segment_sum_kernel) 8 lanes a team,
// K9's 256-bit ladder (g1_wide_team_kernel) and its table's doubling walk
// (msm.cu) 4 lanes a team.
//
// The G2 team (g2_team.cuh) puts four Fq products on lanes for each Fq2
// product and forms each coordinate with a subtraction. Over Fq a product
// is its slot's value: a round puts up to G1_TEAM_PRODUCTS independent Fq
// products on lanes, one a lane (fq_mul1, g2_team.cuh's out-of-line
// mont_mul_cs<12>), each reading its operands from shared memory by
// reference and writing its slot; there is no combine step. The operand
// sums (3A, X + B, D, X3, D - X3, 8C in a doubling; H, 2H, rr, X3, V - X3
// in an addition) are formed once each, into slots, by one lane each
// between two rounds ("sum steps"): no product lane rebuilds one (the G2
// team's operand lanes do, and analysis/step_probe.py puts a G2 round
// inside a point step at about twice its product). Every branch is the
// team's own: every lane reads the same shared values, so a warp never
// diverges on a point's case.
//
// Each step computes the field elements of curve.py's pt_double / pt_add
// (bls381_field.cuh's one-thread pt_double / pt_add), fully reduced, so a
// team's output equals the one-thread code's and the plain versions' limb
// for limb. Where the order of two products differs (Z3 = 2 (Y Z) for
// (2Y) Z, S1 = (Y1 Z2) Z2^2 for Y1 (Z2^2 Z2)) the field element, and so
// its reduced limbs, is the same.
// Plain C++ outside nvcc (a host build runs one lane, and sync() waits for
// nothing); the host shim (analysis/host_shim.py) runs the whole team.
#pragma once
#include "g2_team.cuh"

#define G1_TEAM 32
#define G1_TEAM_PRODUCTS 4
#define G1_SLOTS 20

struct G1Team {
  int lane;  // 0 .. the team's width - 1
  fp* v;     // [G1_SLOTS]: the rounds' products and the sum steps' values
  // the team's lanes in its warp: the whole warp (the 64-bit ladder), or
  // 8 lanes of it (the segment sums') or 4 (the 256-bit ladder's and K9's
  // table walk's): every step uses lanes 0-3
  unsigned mask = 0xffffffffu;
#ifdef __CUDACC__
  __device__ void sync() const { __syncwarp(mask); }
#else
  void sync() const {}  // host builds run one lane: nothing to wait for
#endif
};

// One round: for lane q < n <= G1_TEAM_PRODUCTS, *r = *a * *b with
// sel(q, r, a, b) picking the three by reference (points or slots). No
// lane's r may be another lane's operand in the same round.
template <class Sel>
DEV void team_round(const G1Team& tm, int n, Sel sel) {
  if (tm.lane < n) {
    fp* r;
    const fp *a, *b;
    sel(tm.lane, r, a, b);
    fq_mul1(*r, *a, *b);
  }
  tm.sync();
}

DEV void team_copy(const G1Team& tm, jac<fp>& r, const jac<fp>& p) {
  if (tm.lane == 0) r.x = p.x;
  if (tm.lane == 1) r.y = p.y;
  if (tm.lane == 2) r.z = p.z;
  tm.sync();
}

DEV void team_inf(const G1Team& tm, jac<fp>& r) {
  if (tm.lane == 0) fp_one(r.x);
  if (tm.lane == 1) fp_one(r.y);
  if (tm.lane == 2) fp_zero(r.z);
  tm.sync();
}

// 2P (curve.py pt_double, a = 0; r may be p): 3 rounds, 3 sum steps.
// An infinity (Z = 0) gives Z3 = 0, with pt_double's X3 and Y3.
DEVNI void team_dbl(const G1Team& tm, jac<fp>& r, const jac<fp>& p) {
  fp* v = tm.v;
  const int k = tm.lane;
  enum { A, B, YZ, XB, E, C, T, F, DX, C8, EDX };
  team_round(tm, 3, [&](int q, fp*& o, const fp*& a, const fp*& b) {
    o = &v[q == 0 ? A : q == 1 ? B : YZ];
    a = q == 0 ? &p.x : &p.y;
    b = q == 0 ? &p.x : q == 1 ? &p.y : &p.z;
  });
  // X + B, E = 3A, Z3 = 2 YZ (p.z is read no more)
  if (k == 0) fp_add(v[XB], p.x, v[B]);
  if (k == 1) {
    fp_add(v[E], v[A], v[A]);
    fp_add(v[E], v[E], v[A]);
  }
  if (k == 2) fp_add(r.z, v[YZ], v[YZ]);
  tm.sync();
  // C = B^2, T = (X + B)^2, F = E^2
  team_round(tm, 3, [&](int q, fp*& o, const fp*& a, const fp*& b) {
    o = &v[q == 0 ? C : q == 1 ? T : F];
    a = b = &v[q == 0 ? B : q == 1 ? XB : E];
  });
  // D = 2 (T - A - C), X3 = F - 2D, D - X3; 8C (p.x is read no more)
  if (k == 0) {
    fp d, t;
    fp_sub(d, v[T], v[A]);
    fp_sub(d, d, v[C]);
    fp_add(d, d, d);
    fp_add(t, d, d);
    fp_sub(r.x, v[F], t);
    fp_sub(v[DX], d, r.x);
  }
  if (k == 1) {
    fp_add(v[C8], v[C], v[C]);
    fp_add(v[C8], v[C8], v[C8]);
    fp_add(v[C8], v[C8], v[C8]);
  }
  tm.sync();
  team_round(tm, 1, [&](int, fp*& o, const fp*& a, const fp*& b) {
    o = &v[EDX];
    a = &v[E];
    b = &v[DX];
  });
  // Y3 = E (D - X3) - 8C
  if (k == 0) fp_sub(r.y, v[EDX], v[C8]);
  tm.sync();
}

// P + Q with every case of curve.py pt_add (r may be p or q): an infinity
// operand passes the other through, P == Q doubles, P == -Q gives the
// canonical infinity; else 5 rounds (4, 4, 3, 3 and 2 products) and 3 sum
// steps.
DEVNI void team_add(const G1Team& tm, jac<fp>& r, const jac<fp>& p, const jac<fp>& q) {
  // each case waits for every lane to read it before r (p or q) changes
  if (fp_is_zero(p.z)) { tm.sync(); team_copy(tm, r, q); return; }
  if (fp_is_zero(q.z)) { tm.sync(); team_copy(tm, r, p); return; }
  fp* v = tm.v;
  const int k = tm.lane;
  enum { Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2, U1, U2, S1, S2, H, H2, RR, I, RR2, J, V, ZH, VX, RVX, SJ };
  team_round(tm, 4, [&](int i, fp*& o, const fp*& a, const fp*& b) {
    o = &v[Z1Z1 + i];
    a = i == 0 ? &p.z : i == 1 ? &q.z : i == 2 ? &p.y : &q.y;
    b = i == 0 || i == 3 ? &p.z : &q.z;
  });
  // U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = (Y1 Z2) Z2^2, S2 = (Y2 Z1) Z1^2
  team_round(tm, 4, [&](int i, fp*& o, const fp*& a, const fp*& b) {
    o = &v[U1 + i];
    a = i == 0 ? &p.x : i == 1 ? &q.x : &v[i == 2 ? Y1Z2 : Y2Z1];
    b = &v[i & 1 ? Z1Z1 : Z2Z2];
  });
  // the doubling rewrites U1..S2 (slots 5-8) only after its first round
  if (fp_eq(v[U1], v[U2])) {
    if (fp_eq(v[S1], v[S2])) team_dbl(tm, r, p); else team_inf(tm, r);
    return;
  }
  // H = U2 - U1, 2H; rr = 2 (S2 - S1)
  if (k == 0) {
    fp_sub(v[H], v[U2], v[U1]);
    fp_add(v[H2], v[H], v[H]);
  }
  if (k == 1) {
    fp_sub(v[RR], v[S2], v[S1]);
    fp_add(v[RR], v[RR], v[RR]);
  }
  tm.sync();
  // I = (2H)^2, rr^2, Z1 Z2 (here, not in the first round: no round
  // needs more than 4 lanes)
  team_round(tm, 3, [&](int i, fp*& o, const fp*& a, const fp*& b) {
    o = &v[i == 0 ? I : i == 1 ? RR2 : Z1Z2];
    a = i == 2 ? &p.z : &v[i ? RR : H2];
    b = i == 2 ? &q.z : a;
  });
  // J = H I, V = U1 I, Z1 Z2 H
  team_round(tm, 3, [&](int i, fp*& o, const fp*& a, const fp*& b) {
    o = &v[J + i];
    a = &v[i == 0 ? H : i == 1 ? U1 : Z1Z2];
    b = &v[i == 2 ? H : I];
  });
  // X3 = rr^2 - J - 2V, V - X3; Z3 = 2 Z1Z2H (p and q are read no more)
  if (k == 0) {
    fp t;
    fp_sub(t, v[RR2], v[J]);
    fp_add(r.x, v[V], v[V]);
    fp_sub(r.x, t, r.x);
    fp_sub(v[VX], v[V], r.x);
  }
  if (k == 1) fp_add(r.z, v[ZH], v[ZH]);
  tm.sync();
  // rr (V - X3), S1 J
  team_round(tm, 2, [&](int i, fp*& o, const fp*& a, const fp*& b) {
    o = &v[i ? SJ : RVX];
    a = &v[i ? S1 : RR];
    b = &v[i ? J : VX];
  });
  // Y3 = rr (V - X3) - 2 S1 J
  if (k == 0) {
    fp t;
    fp_add(t, v[SJ], v[SJ]);
    fp_sub(r.y, v[RVX], t);
  }
  tm.sync();
}
