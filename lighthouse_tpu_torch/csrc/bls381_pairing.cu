// K4 launches: the G2 subgroup check and the multi-pairing check of BLS
// batch verification.
//
// Replaces, in the JAX package (lighthouse_tpu/ops/bls381_pairing.py):
//   * :418 g2_subgroup_check_device: psi(Q) == [x]Q with a 64-bit ladder;
//   * :340 multi_pairing_check_device with :211 miller_loop_batch, :325
//     _mask_and_reduce (infinity pairs contribute 1) and :305
//     final_exp_cubed.
// (:440 g2_clear_cofactor_device runs inside the hash-to-G2 kernel, as
// team rounds: bls381_htc.cu team_clear_cofactor.)
//
// The Miller loop follows the host oracle (crypto/bls12_381/pairing.py):
// the G2 point stays on the twist in homogeneous projective coordinates and
// each line is a sparse Fq12 element folded in (f12_mul_by_045). The
// final exponentiation is the oracle's exact one, f^((p^12-1)/r), with
// cyclotomic squarings: the GT convention is the standard exponent (the
// JAX kernel computes its cube; both agree on every check, gcd(3, r) = 1).
//
// Design: every Fq12 computation runs on a team, the 32 lanes of one warp.
// The team's state (the accumulator f, the twist point T, the line, the
// operands of the final exponentiation) lives once in shared memory. A
// round puts each independent product on its own lane: lane k selects
// its operands by index arithmetic (the same code on every lane, no
// divergent product), multiplies and writes the product to shared memory;
// after __syncwarp() a few lanes each form one partial sum or one Fq2
// coordinate of the result with additions. So each of these costs about
// one Fq2 product's latency, not the sum of its products:
//   * an Fq12 product: Karatsuba over Fq6 with schoolbook Fq6 products,
//     27 Fq2 products in one round;
//   * a square: the same 27 (a0 a0, a1 a1, a0 a1);
//   * a line fold: 16; a Frobenius map: 5 (two lanes chain a second);
//   * a cyclotomic square: its nine Fq2 squares as 18 Fq products.
// The kernels:
//   1. miller_kernel: one team per pair, 4 teams a block, as many blocks as
//      the pairs need. A doubling step is 3 rounds (f^2's 27 products with
//      the point's first 5; the point's second 6 beside f^2's sums; the
//      line fold, 16); an addition step 5 (2, 6, 3, 4, then the fold). An
//      infinity pair stores 1, the identity of the product. Out: one Fq12
//      per pair in a scratch buffer.
//   2. pairing_final_kernel: one block of 8 teams: the product over the pairs
//      as a tree (level s: f[j] *= f[j + s] for j a multiple of 2s, the
//      levels apart by __syncthreads(): ceil(log2 m) of them; the value of
//      the product is the same in any order), then team 0 runs the final
//      exponentiation in team rounds. Only the Fq2 inversion inside its
//      Fq12 inverse (a norm, one Fq inversion by the binary extended
//      Euclidean algorithm, two products) runs on one lane.
// Halvings (the doubling step's a and g) are a modular halving, not a
// product. Every value is fully reduced, so the output equals the plain
// version's (ops/bls381_pairing.py) limb for limb. The subgroup check is
// one thread per point.
//
// What bounds it: 32-bit multiply-adds. The bound counts the least Fq
// multiplications the function needs, from the cheapest known way to
// compute it, whatever this kernel does (Fq2 M = 3 Fq, S = 2; Fq6 M = 6
// Fq2 M; Fq12 M = 54, S = 36, a cyclotomic S = 9 Fq2 S = 18; a power to a
// fixed e at the floor of any addition chain: ceil(log2 e) steps, of which
// ceil(log2 popcount(e)) are products):
//   * subgroup check per affine point Q: [|x|]Q is an affine doubling
//     (13), 62 doublings (16) and 5 mixed additions (29); psi(Q) 5 (its
//     x constant is imaginary: 2); comparing it with the Jacobian [x]Q
//     takes Z^2, Z^3 and two products (11): 1,166.
//   * multi-pairing of m affine pairs: one shared accumulator, so the f^2
//     of each of 62 doubling steps (36) is paid once, not per pair; per
//     pair 63 doubling steps (25: 3 M, 6 S and 4 Fq products by x_P, y_P)
//     and 5 addition steps (41: 11 M, 2 S, 4) = 1,780; each of the 68m
//     lines (the first free) a sparse product of 13 Fq2 M = 39. Then one
//     final exponentiation: the easy part 594 (an Fq12 inverse 478: two
//     Fq6 squares, an Fq6 inverse 418 and two Fq6 products; a product, a
//     p^2-Frobenius 8 and a product) and the hard part 6,588 (powers by
//     (x-1)/3, x-1 and three times |x|: 319 steps, 17 of them products;
//     4 products, a p- and a p^2-Frobenius): 7,182. For m = 33: 155,631.
// chip_smoke.py turns these counts into a bound (BLS_FQ_MULS there).
#include "bls381_field.cuh"
#include "mont_cs.cuh"

DEV void fp2_halve(fp2& r, const fp2& a) { fp_half(r.c0, a.c0); fp_half(r.c1, a.c1); }

DEV void fp2_triple(fp2& r, const fp2& a) { fp2 t; fp2_add(t, a, a); fp2_add(r, t, a); }

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define LANES_PER_BLOCK 64
#define TEAM 32          // lanes of a team: one warp
#define TEAM_PRODUCTS 32 // products of one round: one a lane
#define MILLER_TEAMS 4   // teams of a Miller-loop block
#define FINAL_TEAMS 8    // teams of the product-and-final-exponentiation block
#define FQ12_LIMBS 144

// coordinate j < 6 of an Fq12 ([w][v] order), j < 3 of an Fq6
DEV fp2& c12(fp12& f, int j) { return reinterpret_cast<fp2*>(&f)[j]; }
DEV const fp2& c12(const fp12& f, int j) { return reinterpret_cast<const fp2*>(&f)[j]; }
DEV fp2& c6(fp6& f, int j) { return reinterpret_cast<fp2*>(&f)[j]; }
DEV const fp2& c6(const fp6& f, int j) { return reinterpret_cast<const fp2*>(&f)[j]; }

struct Team {
  int lane;
  fp2* prod;  // [TEAM_PRODUCTS] in shared memory: a round's products
  fp2* part;  // [9] in shared memory: partial sums of a round
  DEV void sync() const { __syncwarp(); }
};

// Schoolbook Fq6 products: product (i, j) of x * y, i, j < 3, adds to
// coordinate (i + j) mod 3, times xi when i + j >= 3 (v^3 = xi). Each
// product of a round is one lane's; lane k of a group of nine takes
// i = k / 3, j = k % 3, so every lane runs the same code on other data.
DEV void sch6_out(fp2& r, const fp2* m, int c) {  // m: the nine products [i][j]
  fp2_zero(r);
  UNROLL for (int i = 0; i < 3; i++) {
    const int j = (c - i + 3) % 3;
    fp2 t = m[3 * i + j];
    if (i + j >= 3) fp2_mul_xi(t, t);
    fp2_add(r, r, t);
  }
}

// coordinate k < 3 of v b for an Fq6 b given by its coordinates
DEV void v_coord(fp2& r, const fp2* b, int k) {
  if (k == 0) fp2_mul_xi(r, b[2]); else r = b[k - 1];
}

// coordinate k < 3 of a + v b
DEV void plus_v(fp2& r, const fp2& a, const fp2* b, int k) {
  fp2 t;
  v_coord(t, b, k);
  fp2_add(r, a, t);
}

// r = a * b (r may be a or b) as (a0 b0 + v a1 b1) + ((a0 + a1)(b0 + b1)
// - a0 b0 - a1 b1) w: three schoolbook Fq6 products, 27 Fq2 products
DEVNI void team_fp12_mul(const Team& tm, fp12& r, const fp12& a, const fp12& b) {
  const int k = tm.lane;
  if (k < 27) {
    const int g = k / 9, i = (k % 9) / 3, j = k % 3, o = g == 1 ? 3 : 0;
    fp2 x = c12(a, o + i), y = c12(b, o + j);
    if (g == 2) {
      fp2_add(x, x, c12(a, 3 + i));
      fp2_add(y, y, c12(b, 3 + j));
    }
    fp2_mul(tm.prod[k], x, y);
  }
  tm.sync();
  if (k < 9) sch6_out(tm.part[k], tm.prod + 9 * (k / 3), k % 3);  // part[3g + c]
  tm.sync();
  if (k < 6) {
    fp2 o;
    if (k < 3) {
      plus_v(o, tm.part[k], tm.part + 3, k);
    } else {
      fp2_sub(o, tm.part[6 + k - 3], tm.part[k - 3]);
      fp2_sub(o, o, tm.part[k]);
    }
    c12(r, k) = o;
  }
  tm.sync();
}

// products 0..26 of f^2 = (a0^2 + v a1^2) + 2 a0 a1 w: a0 a0, a1 a1, a0 a1
DEV void sqr12_product(fp2& r, const fp12& f, int k) {
  const int g = k / 9, i = (k % 9) / 3, j = k % 3;
  fp2_mul(r, c12(f, (g == 1 ? 3 : 0) + i), c12(f, (g == 0 ? 0 : 3) + j));
}

// coordinate k < 6 of f^2 from part[9] = the three products' coordinates
DEV void sqr12_out(fp2& o, const fp2* part, int k) {
  if (k < 3) plus_v(o, part[k], part + 3, k);
  else fp2_add(o, part[6 + k - 3], part[6 + k - 3]);
}

// f = f * (c0 + c4 vw + c5 v^2 w), the line l = [c0, c4, c5] (fields.py
// f12_mul_by_045)
DEVNI void team_mul_by_045(const Team& tm, fp12& f, const fp2* l) {
  const int k = tm.lane;
  if (k < 16) {
    fp2 x, y;
    if (k < 6) {  // ta = f.c0 c0, tb = f.c1 c0
      x = c12(f, k);
      y = l[0];
    } else {      // l1 of f.c0 (k < 11) and of f.c1: m1, m2, mx, x0 c4, x0 c5
      const fp6& g = k < 11 ? f.c0 : f.c1;
      switch ((k - 6) % 5) {
        case 0: x = g.c1; y = l[1]; break;
        case 1: x = g.c2; y = l[2]; break;
        case 2: fp2_add(x, g.c1, g.c2); fp2_add(y, l[1], l[2]); break;
        case 3: x = g.c0; y = l[1]; break;
        default: x = g.c0; y = l[2]; break;
      }
    }
    fp2_mul(tm.prod[k], x, y);
  }
  tm.sync();
  if (k < 6) {
    // l1 coordinate i of f.c0 (base 6) or f.c1 (base 11)
    auto l1 = [&](fp2& r, int base, int i) {
      const fp2* m = tm.prod + base;
      fp2 t;
      if (i == 0) { fp2_add(t, m[0], m[1]); fp2_sub(r, m[2], t); fp2_mul_xi(r, r); }
      else if (i == 1) { fp2_mul_xi(t, m[1]); fp2_add(r, m[3], t); }
      else { fp2_add(r, m[4], m[0]); }
    };
    fp2 o, t;
    if (k < 3) {  // f.c0 = ta + v bl1
      if (k == 0) { l1(t, 11, 2); fp2_mul_xi(t, t); } else { l1(t, 11, k - 1); }
      fp2_add(o, tm.prod[k], t);
    } else {      // f.c1 = al1 + tb
      l1(t, 6, k - 3);
      fp2_add(o, t, tm.prod[k]);
    }
    c12(f, k) = o;
  }
  tm.sync();
}

// f = f^2 for a cyclotomic f (Granger-Scott, fields.py
// f12_cyclotomic_sqr): three Fq4 squares (a + b s)^2 = (a^2 + xi b^2,
// (a + b)^2 - a^2 - b^2) of (z0, z1), (z2, z3), (z4, z5), with
// f = ((z0, z4, z3), (z2, z1, z5)).
// Their nine Fq2 squares x^2 = ((x0 + x1)(x0 - x1), 2 x0 x1) are 18 Fq
// products, one a lane.
DEVNI void team_cyc_sqr(const Team& tm, fp12& f) {
  const int k = tm.lane;
  fp* pf = reinterpret_cast<fp*>(tm.prod);
  // the pairs' (a, b) as coordinates of f
  const int pa[3] = {0, 3, 1}, pb[3] = {4, 2, 5};
  if (k < 18) {
    const int q = k / 2, g = q / 3;
    fp2 x;
    if (q % 3 == 0) x = c12(f, pa[g]);
    else if (q % 3 == 1) x = c12(f, pb[g]);
    else fp2_add(x, c12(f, pa[g]), c12(f, pb[g]));
    fp u, w;
    if (k % 2 == 0) { fp_add(u, x.c0, x.c1); fp_sub(w, x.c0, x.c1); }
    else { u = x.c0; w = x.c1; }
    fp_mul(pf[k], u, w);
  }
  tm.sync();
  fp2 o;
  if (k < 6) {
    // coordinate k is 3t - 2z (k < 3) or 3t + 2z, t = r0 (k < 3) or r1 of
    // pair G[k], times xi for z2 (k = 3)
    const int G[6] = {0, 1, 2, 2, 0, 1};
    const int q = 3 * G[k];
    fp2 a2, b2, t, d;
    a2.c0 = pf[2 * q];
    fp_add(a2.c1, pf[2 * q + 1], pf[2 * q + 1]);
    b2.c0 = pf[2 * q + 2];
    fp_add(b2.c1, pf[2 * q + 3], pf[2 * q + 3]);
    if (k < 3) {
      fp2_mul_xi(t, b2);
      fp2_add(t, t, a2);
    } else {
      t.c0 = pf[2 * q + 4];
      fp_add(t.c1, pf[2 * q + 5], pf[2 * q + 5]);
      fp2_add(d, a2, b2);
      fp2_sub(t, t, d);
    }
    if (k == 3) fp2_mul_xi(t, t);
    const fp2& z = c12(f, k);
    if (k < 3) fp2_sub(d, t, z); else fp2_add(d, t, z);
    fp2_add(d, d, d);
    fp2_add(o, d, t);
  }
  tm.sync();
  if (k < 6) c12(f, k) = o;
  tm.sync();
}

// r = a^p (fields.py f12_frob; r may be a)
DEVNI void team_fp12_frob(const Team& tm, fp12& r, const fp12& a) {
  const int k = tm.lane;
  fp2 o;
  if (k < 6) {
    fp2 g;
    fp2_conj(o, c12(a, k));
    if (k % 3 == 1) { fp2_const(g, BLS_G6_1); fp2_mul(o, o, g); }
    if (k % 3 == 2) { fp2_const(g, BLS_G6_2); fp2_mul(o, o, g); }
    if (k >= 3) { fp2_const(g, BLS_G12); fp2_mul(o, o, g); }
  }
  tm.sync();
  if (k < 6) c12(r, k) = o;
  tm.sync();
}

DEVNI void team_conj(const Team& tm, fp12& f) {
  if (tm.lane < 3) fp2_neg(c6(f.c1, tm.lane), c6(f.c1, tm.lane));
  tm.sync();
}

DEVNI void team_copy(const Team& tm, fp12& r, const fp12& a) {
  if (tm.lane < 6) c12(r, tm.lane) = c12(a, tm.lane);
  tm.sync();
}

DEVNI void team_one(const Team& tm, fp12& r) {
  if (tm.lane < 6) {
    if (tm.lane == 0) fp2_one(c12(r, 0)); else fp2_zero(c12(r, tm.lane));
  }
  tm.sync();
}

// r = f^e for a cyclotomic f, e > 0 64 bits, from its top bit (r != f)
DEVNI void team_cyc_pow(const Team& tm, fp12& r, const fp12& f, unsigned long long e) {
  int top = 63;
  while (!((e >> top) & 1)) top--;
  team_copy(tm, r, f);
  for (int i = top - 1; i >= 0; i--) {
    team_cyc_sqr(tm, r);
    if ((e >> i) & 1) team_fp12_mul(tm, r, r, f);
  }
}

// R^3 mod p, mont_inv_binary's last factor
CONSTMEM uint32_t BLS_R3[12] = {0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
                                0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

// a^-1 in Montgomery form by the binary extended Euclidean algorithm
// (mont_cs.cuh; variable time: the pairing's inputs are public), 0 -> 0:
// at most 2 * 381 short steps of shifts and subtractions, against fp_inv's
// 381 squarings and ~190 products in one dependent chain.
DEV void fp_inv_binary(fp& r, const fp& a) {
  fp r3;
  fp_const(r3, BLS_R3);
  mont_inv_binary<12>(r.v, a.v, BLS_P, BLS_NINV, r3.v);
}

struct InvMem { fp6 w, c; fp2 d; };

// r = a^-1 (fields.py f12_inv; r may be a): t = a0^2 - v a1^2, t^-1 by f6_inv,
// then (a0 t^-1, -a1 t^-1)
DEVNI void team_fp12_inv(const Team& tm, fp12& r, const fp12& a, InvMem& s) {
  const int k = tm.lane;
  if (k < 18) {  // a0 a0, a1 a1
    const int o = k < 9 ? 0 : 3, i = (k % 9) / 3, j = k % 3;
    fp2_mul(tm.prod[k], c12(a, o + i), c12(a, o + j));
  }
  tm.sync();
  if (k < 6) sch6_out(tm.part[k], tm.prod + 9 * (k / 3), k % 3);
  tm.sync();
  if (k < 3) {  // w = a0^2 - v a1^2
    fp2 t;
    v_coord(t, tm.part + 3, k);
    fp2_sub(c6(s.w, k), tm.part[k], t);
  }
  tm.sync();
  // f6_inv(w): c0 = w0^2 - xi w1 w2, c1 = xi w2^2 - w0 w1, c2 = w1^2 - w0 w2
  if (k < 6) {
    const int ia[6] = {0, 1, 2, 0, 1, 0}, ib[6] = {0, 2, 2, 1, 1, 2};
    fp2_mul(tm.prod[k], c6(s.w, ia[k]), c6(s.w, ib[k]));
  }
  tm.sync();
  if (k < 3) {
    fp2 t;
    if (k == 0) { fp2_mul_xi(t, tm.prod[1]); fp2_sub(s.c.c0, tm.prod[0], t); }
    else if (k == 1) { fp2_mul_xi(t, tm.prod[2]); fp2_sub(s.c.c1, t, tm.prod[3]); }
    else { fp2_sub(s.c.c2, tm.prod[4], tm.prod[5]); }
  }
  tm.sync();
  // d = xi (w2 c1 + w1 c2) + w0 c0, inverted on lane 0
  if (k < 3) fp2_mul(tm.prod[k], c6(s.w, 2 - k), c6(s.c, (k + 1) % 3));
  tm.sync();
  if (k == 0) {
    fp2 d;
    fp n, t;
    fp2_add(d, tm.prod[0], tm.prod[1]);
    fp2_mul_xi(d, d);
    fp2_add(d, d, tm.prod[2]);
    fp_sqr(n, d.c0);  // fp2_inv: conj(d) / (d0^2 + d1^2)
    fp_sqr(t, d.c1);
    fp_add(n, n, t);
    fp_inv_binary(n, n);
    fp_mul(s.d.c0, d.c0, n);
    fp_mul(t, d.c1, n);
    fp_neg(s.d.c1, t);
  }
  tm.sync();
  if (k < 3) fp2_mul(c6(s.w, k), c6(s.c, k), s.d);  // w = t^-1
  tm.sync();
  if (k < 18) {  // a0 w, a1 w
    const int o = k < 9 ? 0 : 3, i = (k % 9) / 3, j = k % 3;
    fp2_mul(tm.prod[k], c12(a, o + i), c6(s.w, j));
  }
  tm.sync();
  if (k < 6) {
    fp2 x;
    sch6_out(x, tm.prod + 9 * (k / 3), k % 3);
    if (k >= 3) fp2_neg(x, x);
    c12(r, k) = x;
  }
  tm.sync();
}

struct FinalMem { fp12 t, u, y, y2; InvMem inv; };

// r = f^((p^12 - 1)/r), exact (pairing.py final_exponentiation); r may be f
DEVNI void team_final_exp(const Team& tm, fp12& r, const fp12& f, FinalMem& s) {
  team_copy(tm, s.t, f);
  team_conj(tm, s.t);
  team_fp12_inv(tm, s.u, f, s.inv);
  team_fp12_mul(tm, s.t, s.t, s.u);        // f^(p^6 - 1)
  team_fp12_frob(tm, s.u, s.t);
  team_fp12_frob(tm, s.u, s.u);
  team_fp12_mul(tm, s.t, s.u, s.t);        // ^(p^2 + 1)
  team_cyc_pow(tm, s.y, s.t, BLS_M1);
  team_conj(tm, s.y);                      // t^((x-1)/3)
  team_cyc_pow(tm, s.y2, s.y, BLS_M2);
  team_conj(tm, s.y2);                     // y = t^((x-1)^2/3)
  team_cyc_pow(tm, s.u, s.y2, BLS_X_ABS);
  team_conj(tm, s.u);
  team_fp12_frob(tm, s.y, s.y2);
  team_fp12_mul(tm, s.y, s.u, s.y);        // y = y^(x + p)
  team_cyc_pow(tm, s.u, s.y, BLS_X_ABS);
  team_cyc_pow(tm, s.y2, s.u, BLS_X_ABS);
  team_fp12_frob(tm, s.u, s.y);
  team_fp12_frob(tm, s.u, s.u);
  team_fp12_mul(tm, s.y2, s.y2, s.u);
  team_copy(tm, s.u, s.y);
  team_conj(tm, s.u);
  team_fp12_mul(tm, s.y, s.y2, s.u);       // y^(x^2 + p^2 - 1)
  team_fp12_mul(tm, r, s.y, s.t);
}

// A pair's Miller loop state. tmp holds a step's intermediates.
struct MillerMem {
  fp2 prod[TEAM_PRODUCTS];
  fp2 part[9];
  fp2 tmp[8];
  fp2 line[3];  // c0, c4, c5
  fp12 f;
  jac<fp2> T;
  fp2 xq, yq;
  fp xp, yp;
};

DEV void as_fp2(fp2& r, const fp& a) { r.c0 = a; fp_zero(r.c1); }

// f = f^2 and the doubling step on the twist (pairing.py _dbl_step):
// T <- 2T, line at P. Round 1: f^2's 27 products and the point's first
// 5 (32 lanes); round 2: f^2's sums beside the point's 6 products.
DEVNI void team_dbl_step(const Team& tm, MillerMem& M) {
  const int k = tm.lane;
  jac<fp2>& T = M.T;
  if (k < 27) {
    sqr12_product(tm.prod[k], M.f, k);
  } else {
    fp2 x, y;
    switch (k) {
      case 27: x = T.y; y = T.y; break;                   // b = Y^2
      case 28: x = T.z; y = T.z; break;                   // c = Z^2
      case 29: x = T.x; y = T.x; break;                   // j = X^2
      case 30: fp2_add(x, T.y, T.z); y = x; break;        // (Y + Z)^2
      default: x = T.x; y = T.y; break;                   // X Y
    }
    fp2_mul(tm.prod[k], x, y);
  }
  tm.sync();
  fp2* t = M.tmp;  // 0 b, 1 e, 2 3e, 3 g, 4 i, 5 h, 6 a, 7 3j
  if (k < 9) {
    sch6_out(tm.part[k], tm.prod + 9 * (k / 3), k % 3);
  } else if (k == 9) {
    fp2 e, f3, g;
    t[0] = tm.prod[27];
    fp2_triple(e, tm.prod[28]);  // 3c
    fp2_mul_xi(e, e);            // b' 3c = 4 xi 3c
    fp2_add(e, e, e);
    fp2_add(e, e, e);
    t[1] = e;
    fp2_triple(f3, e);
    t[2] = f3;
    fp2_add(g, tm.prod[27], f3);
    fp2_halve(t[3], g);
    fp2_sub(t[4], e, tm.prod[27]);
  } else if (k == 10) {
    fp2 s;
    fp2_add(s, tm.prod[27], tm.prod[28]);
    fp2_sub(t[5], tm.prod[30], s);
  } else if (k == 11) {
    fp2_halve(t[6], tm.prod[31]);
  } else if (k == 12) {
    fp2_triple(t[7], tm.prod[29]);
  }
  tm.sync();
  if (k < 6) {
    fp2 o;
    sqr12_out(o, tm.part, k);
    c12(M.f, k) = o;
  } else if (k < 12) {
    fp2 x, y;
    switch (k) {
      case 6: x = t[1]; y = t[1]; break;                    // e^2
      case 7: x = t[6]; fp2_sub(y, t[0], t[2]); break;      // a (b - 3e)
      case 8: x = t[3]; y = t[3]; break;                    // g^2
      case 9: x = t[0]; y = t[5]; break;                    // b h
      case 10: x = t[5]; as_fp2(y, M.yp); break;            // h y_P
      default: x = t[7]; as_fp2(y, M.xp); break;            // 3j x_P
    }
    fp2_mul(tm.prod[k - 6], x, y);
  }
  tm.sync();
  if (k < 6) {
    fp2 o;
    switch (k) {
      case 0: T.x = tm.prod[1]; break;
      case 1: fp2_triple(o, tm.prod[0]); fp2_sub(T.y, tm.prod[2], o); break;
      case 2: T.z = tm.prod[3]; break;
      case 3: fp2_neg(o, tm.prod[4]); fp2_mul_xi(M.line[0], o); break;
      case 4: M.line[1] = t[4]; break;
      default: M.line[2] = tm.prod[5]; break;
    }
  }
  tm.sync();
}

// The mixed addition step T <- T + Q, line at P (pairing.py _add_step)
DEVNI void team_add_step(const Team& tm, MillerMem& M) {
  const int k = tm.lane;
  jac<fp2>& T = M.T;
  fp2* t = M.tmp;  // 0 theta, 1 lam, 2 cc, 3 dd, 4 ee, 5 hh, 6 gg
  if (k < 2) fp2_mul(tm.prod[k], k ? M.xq : M.yq, T.z);
  tm.sync();
  if (k < 2) fp2_sub(t[k], k ? T.x : T.y, tm.prod[k]);
  tm.sync();
  if (k < 6) {
    fp2 x, y;
    switch (k) {
      case 0: x = t[0]; y = t[0]; break;                    // cc = theta^2
      case 1: x = t[1]; y = t[1]; break;                    // dd = lam^2
      case 2: x = t[0]; y = M.xq; break;
      case 3: x = t[1]; y = M.yq; break;
      case 4: x = t[1]; as_fp2(y, M.yp); break;
      default: x = t[0]; as_fp2(y, M.xp); break;
    }
    fp2_mul(tm.prod[k], x, y);
  }
  tm.sync();
  if (k < 5) {
    fp2 o;
    switch (k) {
      case 0: t[2] = tm.prod[0]; break;
      case 1: t[3] = tm.prod[1]; break;
      case 2: fp2_sub(o, tm.prod[3], tm.prod[2]); M.line[1] = o; break;  // c4 = -(theta xq - lam yq)
      case 3: fp2_neg(o, tm.prod[4]); fp2_mul_xi(M.line[0], o); break;   // c0 = xi (-lam y_P)
      default: M.line[2] = tm.prod[5]; break;                            // c5 = theta x_P
    }
  }
  tm.sync();
  if (k < 3) {
    switch (k) {
      case 0: fp2_mul(tm.prod[0], t[1], t[3]); break;   // ee = lam dd
      case 1: fp2_mul(tm.prod[1], T.z, t[2]); break;    // ff = Z cc
      default: fp2_mul(tm.prod[2], T.x, t[3]); break;   // gg = X dd
    }
  }
  tm.sync();
  if (k == 0) {
    fp2 h;
    t[4] = tm.prod[0];
    t[6] = tm.prod[2];
    fp2_add(h, tm.prod[2], tm.prod[2]);
    fp2_sub(h, tm.prod[0], h);
    fp2_add(t[5], h, tm.prod[1]);
  }
  tm.sync();
  if (k < 4) {
    fp2 x, y;
    switch (k) {
      case 0: x = t[1]; y = t[5]; break;                    // lam hh
      case 1: x = t[0]; fp2_sub(y, t[6], t[5]); break;      // theta (gg - hh)
      case 2: x = t[4]; y = T.y; break;                     // ee Y
      default: x = T.z; y = t[4]; break;                    // Z ee
    }
    fp2_mul(tm.prod[k], x, y);
  }
  tm.sync();
  if (k < 3) {
    if (k == 0) T.x = tm.prod[0];
    else if (k == 1) fp2_sub(T.y, tm.prod[1], tm.prod[2]);
    else T.z = tm.prod[3];
  }
  tm.sync();
}

// f_{|x|,Q}(P), conjugated for x < 0 (pairing.py miller_loop), into M.f
DEVNI void team_miller_loop(const Team& tm, MillerMem& M) {
  if (tm.lane < 6) {
    if (tm.lane == 0) fp2_one(c12(M.f, 0)); else fp2_zero(c12(M.f, tm.lane));
  } else if (tm.lane == 6) {
    M.T.x = M.xq; M.T.y = M.yq; fp2_one(M.T.z);
  }
  tm.sync();
  for (int i = 62; i >= 0; i--) {
    team_dbl_step(tm, M);
    team_mul_by_045(tm, M.f, M.line);
    if ((BLS_X_ABS >> i) & 1) {
      team_add_step(tm, M);
      team_mul_by_045(tm, M.f, M.line);
    }
  }
  team_conj(tm, M.f);
}

// the team's lanes copy 144 limbs between an Fq12 and device memory
DEV void team_ld12(const Team& tm, fp12& f, const long long* src) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&f);
  for (int j = tm.lane; j < FQ12_LIMBS; j += TEAM) w[j] = (uint32_t)src[j];
  tm.sync();
}
DEV void team_st12(const Team& tm, long long* dst, const fp12& f) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&f);
  for (int j = tm.lane; j < FQ12_LIMBS; j += TEAM) dst[j] = (long long)w[j];
  tm.sync();
}

// q [n, 2, 2, 12] affine, q_inf [n] -> ok [n]
__global__ void __launch_bounds__(LANES_PER_BLOCK)
subgroup_check_kernel(const long long* q, const unsigned char* q_inf, unsigned char* ok, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (q_inf[i]) { ok[i] = 1; return; }
  fp2 x, y;
  fp2_ld(x, q + i * 48);
  fp2_ld(y, q + i * 48 + 24);
  ok[i] = g2_in_subgroup(x, y) ? 1 : 0;
}

// team i: pair i's Miller loop (1 for an infinity pair) -> scratch [m, 144]
__global__ void __launch_bounds__(MILLER_TEAMS * TEAM)
miller_kernel(const long long* p, const unsigned char* p_inf, const long long* q, const unsigned char* q_inf,
              long long* scratch, int m) {
  __shared__ MillerMem mem[MILLER_TEAMS];
  const int team = threadIdx.x / TEAM;
  const long long i = (long long)blockIdx.x * MILLER_TEAMS + team;
  if (i >= m) return;
  MillerMem& M = mem[team];
  const Team tm{(int)(threadIdx.x % TEAM), M.prod, M.part};
  if (p_inf[i] || q_inf[i]) {
    team_one(tm, M.f);
  } else {
    if (tm.lane == 0) {
      fp_ld(M.xp, p + i * 24);
      fp_ld(M.yp, p + i * 24 + 12);
      fp2_ld(M.xq, q + i * 48);
      fp2_ld(M.yq, q + i * 48 + 24);
    }
    tm.sync();
    team_miller_loop(tm, M);
  }
  team_st12(tm, scratch + i * FQ12_LIMBS, M.f);
}

struct TreeMem {
  fp2 prod[TEAM_PRODUCTS];
  fp2 part[9];
  fp12 a, b;
};

// scratch [m, 144] -> out [144] = final_exp(prod of the m values); the
// tree overwrites scratch
__global__ void __launch_bounds__(FINAL_TEAMS * TEAM)
pairing_final_kernel(long long* scratch, long long* out, int m) {
  __shared__ TreeMem mem[FINAL_TEAMS];
  __shared__ FinalMem fin;
  const int team = threadIdx.x / TEAM;
  TreeMem& M = mem[team];
  const Team tm{(int)(threadIdx.x % TEAM), M.prod, M.part};
  for (long long s = 1; s < m; s *= 2) {
    for (long long j = 2 * s * team; j + s < m; j += 2 * s * FINAL_TEAMS) {
      team_ld12(tm, M.a, scratch + j * FQ12_LIMBS);
      team_ld12(tm, M.b, scratch + (j + s) * FQ12_LIMBS);
      team_fp12_mul(tm, M.a, M.a, M.b);
      team_st12(tm, scratch + j * FQ12_LIMBS, M.a);
    }
    __syncthreads();
  }
  if (team != 0) return;
  if (m > 0) team_ld12(tm, M.a, scratch); else team_one(tm, M.a);
  team_final_exp(tm, M.a, M.a, fin);
  team_st12(tm, out, M.a);
}

extern "C" {

int bls_g2_subgroup_check(const long long* q, const unsigned char* q_inf, unsigned char* ok,
                          long long n, void* stream) {
  unsigned grid = (unsigned)((n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK);
  subgroup_check_kernel<<<grid, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(q, q_inf, ok, n);
  return (int)cudaGetLastError();
}

// scratch [max(m, 1), 144], out [144]
int bls_multi_pairing(const long long* p, const unsigned char* p_inf, const long long* q,
                      const unsigned char* q_inf, long long* scratch, long long* out, int m,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m > 0) {
    miller_kernel<<<(unsigned)((m + MILLER_TEAMS - 1) / MILLER_TEAMS), MILLER_TEAMS * TEAM, 0, st>>>(
        p, p_inf, q, q_inf, scratch, m);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  pairing_final_kernel<<<1, FINAL_TEAMS * TEAM, 0, st>>>(scratch, out, m);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
