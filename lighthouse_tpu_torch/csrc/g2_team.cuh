// Warp-team G2 arithmetic: a warp works on one Jacobian point over Fq2
// together. Shared by K5's hash-to-G2 (bls381_htc.cu: the sum on E', the
// isogeny, the cofactor clearing), K2's G2 ladder (bls381_g.cu) and K4's
// subgroup check (bls381_pairing.cu); its fq_mul1 also serves the G1 team
// (g1_team.cuh).
//
// The team's state lives in shared memory, and each round puts up to eight
// Fq2 products on the warp's lanes, four Fq products each (schoolbook: no
// sums before the products), one a lane. A lane writes its two Fq
// operands into shared memory (a coordinate picked by reference, or of a
// sum), multiplies, and two lanes an Fq2 form its coordinates with one
// subtraction each, so a round costs about one Fq product and a few
// additions. Every branch is the team's own: every lane reads the same
// shared values, so a warp never diverges on a point's case. Each step
// computes the field elements of curve.py's pt_double / pt_add (and
// bls381_field.cuh's one-thread pt_double / pt_add), all fully reduced, so
// a team's output equals the one-thread code's and the plain versions'
// limb for limb.
//
// Products are mont_mul_cs (mont_cs.cuh) on registers, not the shared
// fp_mul; a team lane's product is one out-of-line copy (fq_mul1).
// Plain C++ outside nvcc, as the headers it includes (a host build runs
// one lane, and sync() waits for nothing).
#pragma once
#include "bls381_field.cuh"
#include "mont_cs.cuh"

// ---------------------------------------------------------------------------
// Fq and Fq2 on the column-sum product
// ---------------------------------------------------------------------------

DEV void fq_mulx(fp& r, const fp& a, const fp& b) { mont_mul_cs<12>(r.v, a.v, b.v, BLS_P, BLS_NINV); }

// one out-of-line copy for the products that stand alone (a team lane's,
// the map's single ones): the inlined copies stay where they interleave
DEVNI void fq_mul1(fp& r, const fp& a, const fp& b) { fq_mulx(r, a, b); }

// Karatsuba: three independent products, interleaved by the compiler
DEVNI void fq2_mulx(fp2& r, const fp2& a, const fp2& b) {
  fp t0, t1, x, sa, sb;
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fq_mulx(t0, a.c0, b.c0);
  fq_mulx(t1, a.c1, b.c1);
  fq_mulx(x, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(x, x, t0);
  fp_sub(r.c1, x, t1);
}

DEVNI void fq2_sqrx(fp2& r, const fp2& a) {
  fp s, d, t, c0;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fq_mulx(c0, s, d);
  fq_mulx(t, a.c0, a.c1);
  r.c0 = c0;
  fp_add(r.c1, t, t);
}

// a product and a square over Fq or Fq2 on the column-sum product, for
// code generic in the field (bls381_field.cuh's f_mul/f_sqr run fp_mul)
DEV void fx_mul(fp& r, const fp& a, const fp& b) { fq_mulx(r, a, b); }
DEV void fx_mul(fp2& r, const fp2& a, const fp2& b) { fq2_mulx(r, a, b); }
DEV void fx_sqr(fp& r, const fp& a) { fq_mulx(r, a, a); }
DEV void fx_sqr(fp2& r, const fp2& a) { fq2_sqrx(r, a); }

// ---------------------------------------------------------------------------
// Team rounds on a warp: points and named values in shared memory
// ---------------------------------------------------------------------------

#define G2_TEAM 32
#define G2_SLOTS 16

struct G2Team {
  int lane;
  fp* opa;   // [32]: a round's operands, one pair a lane
  fp* opb;
  fp* prod;  // [32]: a round's Fq products, one a lane
  fp2* v;    // [G2_SLOTS]: the rounds' results, by slot
#ifdef __CUDACC__
  __device__ void sync() const { __syncwarp(); }
#else
  void sync() const {}  // host builds run one lane: nothing to wait for
#endif
};

// coordinate i of an Fq2
DEV const fp& cpt(const fp2& a, int i) { return i ? a.c1 : a.c0; }

// One round: v[base + q] = x_q * y_q for q < n <= 8, each Fq2 product as
// four Fq products x_i y_j on lanes 4q + 2i + j (schoolbook: no sums
// before the products). sel(q, i, j, a, b) writes the lane's operands x_i
// and y_j into shared memory (a reference picked, or a coordinate of a
// sum), the product reads them there. The x_1 y_0 lane negates its
// product, so both coordinates come out of one subtraction on two lanes:
// x0 y0 - x1 y1 and x0 y1 - (-x1 y0).
template <class Sel>
DEV void team_round(const G2Team& tm, int n, int base, Sel sel) {
  const int k = tm.lane;
  if (k < 4 * n) {
    sel(k >> 2, (k >> 1) & 1, k & 1, tm.opa[k], tm.opb[k]);
    fq_mul1(tm.prod[k], tm.opa[k], tm.opb[k]);
    if ((k & 3) == 2) fp_neg(tm.prod[k], tm.prod[k]);
  }
  tm.sync();
  if (k < 2 * n) {
    const int q = k >> 1, c = k & 1;
    fp_sub(c ? tm.v[base + q].c1 : tm.v[base + q].c0, tm.prod[4 * q + c], tm.prod[4 * q + 3 - c]);
  }
  tm.sync();
}

DEV void team_copy(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p) {
  if (tm.lane == 0) r.x = p.x;
  if (tm.lane == 1) r.y = p.y;
  if (tm.lane == 2) r.z = p.z;
  tm.sync();
}

DEV void team_neg(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p) {
  if (tm.lane == 0) r.x = p.x;
  if (tm.lane == 1) fp2_neg(r.y, p.y);
  if (tm.lane == 2) r.z = p.z;
  tm.sync();
}

DEV void team_inf(const G2Team& tm, jac<fp2>& r) {
  if (tm.lane == 0) fp2_one(r.x);
  if (tm.lane == 1) fp2_one(r.y);
  if (tm.lane == 2) fp2_zero(r.z);
  tm.sync();
}

// 2P (curve.py pt_double; r may be p): 3 rounds. With a_coef, the
// general-a form on E' (E = 3 X^2 + a Z^4): 5 rounds.
DEVNI void team_dbl(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p, bool a_coef) {
  fp2* v = tm.v;
  // slots: A 0, B 1, YZ 2, ZZ 3, C 4, T 5, F or Z4 6, aZ4 7, F 8, Y3 9
  team_round(tm, a_coef ? 4 : 3, 0, [&](int q, int i, int j, fp& a, fp& b) {
    const fp2& x = q == 0 ? p.x : q == 3 ? p.z : p.y;
    const fp2& y = q == 0 ? p.x : q == 1 ? p.y : p.z;
    a = cpt(x, i);
    b = cpt(y, j);
  });
  auto e_of = [&](fp& e, int i) {  // coordinate i of 3A (+ a Z^4)
    fp_add(e, cpt(v[0], i), cpt(v[0], i));
    fp_add(e, e, cpt(v[0], i));
    if (a_coef) fp_add(e, e, cpt(v[7], i));
  };
  // B^2, (X + B)^2, and E^2 (a = 0) or Z^4
  team_round(tm, 3, 4, [&](int q, int i, int j, fp& a, fp& b) {
    if (q == 1) {
      fp_add(a, cpt(p.x, i), cpt(v[1], i));
      fp_add(b, cpt(p.x, j), cpt(v[1], j));
    } else if (q == 2 && !a_coef) {
      e_of(a, i);
      e_of(b, j);
    } else {
      const fp2& x = q == 0 ? v[1] : v[3];
      a = cpt(x, i);
      b = cpt(x, j);
    }
  });
  const int f = a_coef ? 8 : 6;
  if (a_coef) {
    team_round(tm, 1, 7, [&](int, int i, int j, fp& a, fp& b) {
      fp_const(a, BLS_SSWU_A[i]);
      b = cpt(v[6], j);
    });
    team_round(tm, 1, 8, [&](int, int i, int j, fp& a, fp& b) {
      e_of(a, i);
      e_of(b, j);
    });
  }
  // coordinate i of D = 2 ((X + B)^2 - A - C) and of X3 = F - 2D
  auto d_x3 = [&](fp& d, fp& x3, int i) {
    fp_sub(d, cpt(v[5], i), cpt(v[0], i));
    fp_sub(d, d, cpt(v[4], i));
    fp_add(d, d, d);
    fp_add(x3, d, d);
    fp_sub(x3, cpt(v[f], i), x3);
  };
  team_round(tm, 1, 9, [&](int, int i, int j, fp& a, fp& b) {
    fp d, x3;
    e_of(a, i);
    d_x3(d, x3, j);
    fp_sub(b, d, x3);
  });
  // lanes 0-5: coordinate k % 2 of X3, Y3 = E (D - X3) - 8C, Z3 = 2 YZ
  const int k = tm.lane;
  if (k < 6) {
    const int i = k & 1;
    fp o, d, c8;
    if (k < 2) {
      d_x3(d, o, i);
      (i ? r.x.c1 : r.x.c0) = o;
    } else if (k < 4) {
      fp_add(c8, cpt(v[4], i), cpt(v[4], i));
      fp_add(c8, c8, c8);
      fp_add(c8, c8, c8);
      fp_sub(i ? r.y.c1 : r.y.c0, cpt(v[9], i), c8);
    } else {
      fp_add(i ? r.z.c1 : r.z.c0, cpt(v[2], i), cpt(v[2], i));
    }
  }
  tm.sync();
}

// The rest of P + Q once U1, U2, S1 and S2 are in slots 2, 3, 6 and 7
// (team_add, team_madd): P == Q doubles, P == -Q gives the canonical
// infinity, else 3 rounds. Z3 = 2 (Z1 Z2) H.
DEV void team_add_finish(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p, const jac<fp2>& q, bool a_coef) {
  fp2* v = tm.v;
  if (fp2_eq(v[2], v[3])) {
    if (fp2_eq(v[6], v[7])) team_dbl(tm, r, p, a_coef); else team_inf(tm, r);
    return;
  }
  // coordinate i of H = U2 - U1 and rr = 2 (S2 - S1); slots: I 8, rr^2 9,
  // Z1Z2 10, J 11, V 12, Z1Z2H 13, rr (V - X3) 14, S1 J 15
  auto h_of = [&](fp& h, int i) { fp_sub(h, cpt(v[3], i), cpt(v[2], i)); };
  auto rr_of = [&](fp& rr, int i) {
    fp_sub(rr, cpt(v[7], i), cpt(v[6], i));
    fp_add(rr, rr, rr);
  };
  team_round(tm, 3, 8, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) {
      h_of(a, i);
      fp_add(a, a, a);
      h_of(b, j);
      fp_add(b, b, b);
    } else if (k == 1) {
      rr_of(a, i);
      rr_of(b, j);
    } else {
      a = cpt(p.z, i);
      b = cpt(q.z, j);
    }
  });
  team_round(tm, 3, 11, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 2) { a = cpt(v[10], i); h_of(b, j); }
    else { if (k == 0) h_of(a, i); else a = cpt(v[2], i); b = cpt(v[8], j); }
  });
  auto x3_of = [&](fp& x3, int i) {  // coordinate i of rr^2 - J - 2V
    fp t;
    fp_sub(x3, cpt(v[9], i), cpt(v[11], i));
    fp_add(t, cpt(v[12], i), cpt(v[12], i));
    fp_sub(x3, x3, t);
  };
  team_round(tm, 2, 14, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) {
      fp x3;
      rr_of(a, i);
      x3_of(x3, j);
      fp_sub(b, cpt(v[12], j), x3);
    } else {
      a = cpt(v[6], i);
      b = cpt(v[11], j);
    }
  });
  // lanes 0-5: coordinate k % 2 of X3, Y3 = rr (V - X3) - 2 S1 J, Z3 = 2 Z1Z2H
  const int k = tm.lane;
  if (k < 6) {
    const int i = k & 1;
    fp o;
    if (k < 2) {
      x3_of(o, i);
      (i ? r.x.c1 : r.x.c0) = o;
    } else if (k < 4) {
      fp_add(o, cpt(v[15], i), cpt(v[15], i));
      fp_sub(i ? r.y.c1 : r.y.c0, cpt(v[14], i), o);
    } else {
      fp_add(i ? r.z.c1 : r.z.c0, cpt(v[13], i), cpt(v[13], i));
    }
  }
  tm.sync();
}

// P + Q with every case of curve.py pt_add (r may be p or q): an infinity
// operand passes the other through, P == Q doubles (general a on E'),
// P == -Q gives the canonical infinity. The branches are the team's own
// (every lane reads the same shared values).
DEVNI void team_add(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p, const jac<fp2>& q, bool a_coef) {
  // each case waits for every lane to read it before r (p or q) changes
  if (fp2_is_zero(p.z)) { tm.sync(); team_copy(tm, r, q); return; }
  if (fp2_is_zero(q.z)) { tm.sync(); team_copy(tm, r, p); return; }
  fp2* v = tm.v;
  // slots: Z1Z1 0, Z2Z2 1, U1 2, U2 3, T1 4, T2 5, S1 6, S2 7
  team_round(tm, 2, 0, [&](int k, int i, int j, fp& a, fp& b) {
    const fp2& z = k == 0 ? p.z : q.z;
    a = cpt(z, i);
    b = cpt(z, j);
  });
  team_round(tm, 4, 2, [&](int k, int i, int j, fp& a, fp& b) {
    const fp2& x = k == 0 ? p.x : k == 1 ? q.x : k == 2 ? v[1] : v[0];
    const fp2& y = k == 0 ? v[1] : k == 1 ? v[0] : k == 2 ? q.z : p.z;
    a = cpt(x, i);
    b = cpt(y, j);
  });
  team_round(tm, 2, 6, [&](int k, int i, int j, fp& a, fp& b) {
    a = cpt(k == 0 ? p.y : q.y, i);
    b = cpt(k == 0 ? v[4] : v[5], j);
  });
  team_add_finish(tm, r, p, q, a_coef);
}

// P + Q for an affine Q (Z2 = 1, the same for the whole team; r may be
// p): team_add's values in 5 rounds, not 6. With Z2 = 1, U1 = X1 and
// S1 = Y1 come out of products by Z2 (exact), and S2 = (Y2 Z1) Z1Z1
// needs no Z1^3 first.
DEVNI void team_madd(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p, const jac<fp2>& q) {
  if (fp2_is_zero(p.z)) { tm.sync(); team_copy(tm, r, q); return; }
  fp2* v = tm.v;
  // slots: Z1Z1 0, Y2 Z1 1, U1 2, U2 3, S1 6, S2 7 (team_add's); the
  // lanes of slots 4 and 5 repeat S1's product
  team_round(tm, 3, 0, [&](int k, int i, int j, fp& a, fp& b) {
    a = cpt(k == 0 ? p.z : k == 1 ? q.y : p.x, i);
    b = cpt(k == 2 ? q.z : p.z, j);
  });
  team_round(tm, 5, 3, [&](int k, int i, int j, fp& a, fp& b) {
    if (k == 0) {
      a = cpt(q.x, i);
      b = cpt(v[0], j);
    } else if (k == 4) {
      a = cpt(v[1], i);
      b = cpt(v[0], j);
    } else {
      a = cpt(p.y, i);
      b = cpt(q.z, j);
    }
  });
  team_add_finish(tm, r, p, q, false);
}
