// golden — scalar C++ reference implementations (the bit-exactness oracle).
//
// Role: what liquid-dsp is to the reference wrapper (SURVEY.md section 2.2),
// this library is to the JAX framework: an independent, scalar, native
// implementation of every codec/DSP primitive, against which the batched
// JAX/Pallas ops are tested bit-exactly (SURVEY.md section 7.1 "golden/").
//
// Everything here implements the SAME framework spec as liquiddsp_tpu/ops
// (documented in those modules' docstrings): msequence taps g>>1, CRC-24/
// OPENPGP, gray PSK/ASK/QAM tables with serpentine cross-QAM32, systematic
// block codes, K=7 (133,171) convolutional code with the framework puncture
// patterns, RS(255,223) over GF(2^8)/0x11D (fcr=1), unit-energy RRC at
// k=2/m=7/beta=0.3, and the [preamble|header|payload] frame assembly.
//
// Exposed as extern "C" for ctypes (no pybind11 in this environment).

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

using cf = std::complex<float>;

extern "C" {

// ---------------------------------------------------------------------------
// msequence (spec: liquiddsp_tpu/ops/msequence.py)
// ---------------------------------------------------------------------------

void golden_msequence(unsigned m, unsigned g, unsigned a, unsigned n,
                      uint8_t* out) {
  unsigned mask = (1u << m) - 1u;
  unsigned taps = g >> 1;
  unsigned v = a & mask;
  for (unsigned i = 0; i < n; i++) {
    unsigned b = __builtin_popcount(v & taps) & 1u;
    out[i] = (uint8_t)b;
    v = ((v << 1) | b) & mask;
  }
}

void golden_preamble(float* out_re, float* out_im, unsigned n_syms) {
  std::vector<uint8_t> bits(2 * n_syms);
  golden_msequence(7, 0x0089, 1, 2 * n_syms, bits.data());
  const float s = (float)M_SQRT1_2;
  for (unsigned i = 0; i < n_syms; i++) {
    out_re[i] = bits[2 * i] ? s : -s;
    out_im[i] = bits[2 * i + 1] ? s : -s;
  }
}

// ---------------------------------------------------------------------------
// CRC (spec: liquiddsp_tpu/ops/crc.py)
// ---------------------------------------------------------------------------

static uint32_t crc_msb(const uint8_t* data, unsigned len, uint32_t poly,
                        unsigned width, uint32_t init) {
  uint32_t topbit = 1u << (width - 1);
  uint32_t mask = (width == 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  uint32_t reg = init;
  for (unsigned i = 0; i < len; i++) {
    reg ^= ((uint32_t)data[i]) << (width - 8);
    for (int b = 0; b < 8; b++)
      reg = (reg & topbit) ? ((reg << 1) ^ poly) & mask : (reg << 1) & mask;
  }
  return reg;
}

uint32_t golden_crc24(const uint8_t* data, unsigned len) {
  return crc_msb(data, len, 0x864CFB, 24, 0xB704CE);
}

uint32_t golden_crc16(const uint8_t* data, unsigned len) {
  return crc_msb(data, len, 0x1021, 16, 0xFFFF);
}

// ---------------------------------------------------------------------------
// RRC pulse (spec: liquiddsp_tpu/ops/rrc.py; k=2, m=7, beta=0.3)
// ---------------------------------------------------------------------------

void golden_rrc_taps(unsigned k, unsigned m, double beta, double dt,
                     float* out /* 2*k*m+1 */) {
  unsigned len = 2 * k * m + 1;
  std::vector<double> h(len);
  double energy = 0.0;
  for (unsigned i = 0; i < len; i++) {
    double t = ((double)i - (double)(k * m) - dt) / (double)k;
    double v;
    if (std::fabs(t) < 1e-9) {
      v = 1.0 - beta + 4.0 * beta / M_PI;
    } else if (std::fabs(std::fabs(t) - 1.0 / (4.0 * beta)) < 1e-9) {
      v = (beta / std::sqrt(2.0)) *
          ((1.0 + 2.0 / M_PI) * std::sin(M_PI / (4.0 * beta)) +
           (1.0 - 2.0 / M_PI) * std::cos(M_PI / (4.0 * beta)));
    } else {
      double num = std::sin(M_PI * t * (1.0 - beta)) +
                   4.0 * beta * t * std::cos(M_PI * t * (1.0 + beta));
      double den = M_PI * t * (1.0 - std::pow(4.0 * beta * t, 2.0));
      v = num / den;
    }
    h[i] = v;
    energy += v * v;
  }
  double norm = 1.0 / std::sqrt(energy);
  for (unsigned i = 0; i < len; i++) out[i] = (float)(h[i] * norm);
}

// ---------------------------------------------------------------------------
// modem tables (spec: liquiddsp_tpu/ops/modem.py)
// ---------------------------------------------------------------------------

static unsigned gray_encode(unsigned x) { return x ^ (x >> 1); }

// gray-coded PAM levels: table[data] = level
static void pam_table(unsigned nbits, double* table) {
  unsigned n = 1u << nbits;
  for (unsigned pos = 0; pos < n; pos++)
    table[gray_encode(pos)] = 2.0 * pos - (double)(n - 1);
}

static void psk_table(unsigned nbits, cf* table) {
  unsigned m = 1u << nbits;
  for (unsigned pos = 0; pos < m; pos++) {
    double th = 2.0 * M_PI * pos / m;
    table[gray_encode(pos)] = cf((float)std::cos(th), (float)std::sin(th));
  }
}

// mod index space 0-10 (reference lib/flex_tx_impl.cc:76-116)
int golden_constellation(unsigned mod, float* out_re, float* out_im) {
  static const unsigned BPS[11] = {1, 2, 3, 4, 1, 2, 3, 2, 4, 5, 6};
  if (mod > 10) return -1;
  unsigned m = 1u << BPS[mod];
  std::vector<cf> t(m);
  if (mod == 0) {  // PSK2
    t[0] = cf(1, 0);
    t[1] = cf(-1, 0);
  } else if (mod == 1) {  // PSK4: (+-1 +-1j)/sqrt2, bits (I sign, Q sign)
    float s = (float)M_SQRT1_2;
    t[0] = cf(s, s); t[1] = cf(s, -s); t[2] = cf(-s, s); t[3] = cf(-s, -s);
  } else if (mod == 2 || mod == 6) {
    psk_table(3, t.data());
  } else if (mod == 3) {
    psk_table(4, t.data());
  } else if (mod == 4) {
    psk_table(1, t.data());
  } else if (mod == 5) {
    psk_table(2, t.data());
  } else if (mod == 7) {  // ASK4
    double pam[4]; pam_table(2, pam);
    for (unsigned i = 0; i < 4; i++) t[i] = cf((float)(pam[i] / std::sqrt(5.0)), 0);
  } else if (mod == 8) {  // QAM16
    double pam[4]; pam_table(2, pam);
    for (unsigned i = 0; i < 16; i++)
      t[i] = cf((float)(pam[i >> 2] / std::sqrt(10.0)),
                (float)(pam[i & 3] / std::sqrt(10.0)));
  } else if (mod == 10) {  // QAM64
    double pam[8]; pam_table(3, pam);
    for (unsigned i = 0; i < 64; i++)
      t[i] = cf((float)(pam[i >> 3] / std::sqrt(42.0)),
                (float)(pam[i & 7] / std::sqrt(42.0)));
  } else if (mod == 9) {  // QAM32 cross, serpentine order
    static const double axis[6] = {-5, -3, -1, 1, 3, 5};
    unsigned idx = 0;
    for (int r = 0; r < 6; r++) {
      double q = axis[5 - r];
      std::vector<cf> row;
      for (int c = 0; c < 6; c++) {
        double ii = axis[c];
        if (std::fabs(ii) == 5 && std::fabs(q) == 5) continue;
        row.push_back(cf((float)ii, (float)q));
      }
      if (r % 2) for (size_t c = row.size(); c-- > 0;) t[idx++] = row[c];
      else for (auto& p : row) t[idx++] = p;
    }
    double e = 0; for (auto& p : t) e += std::norm(p);
    double norm = 1.0 / std::sqrt(e / 32.0);
    for (auto& p : t) p *= (float)norm;
  }
  // exact unit average energy
  double e = 0; for (auto& p : t) e += std::norm(p);
  double norm = 1.0 / std::sqrt(e / m);
  for (unsigned i = 0; i < m; i++) {
    out_re[i] = t[i].real() * (float)norm;
    out_im[i] = t[i].imag() * (float)norm;
  }
  return (int)m;
}

// ---------------------------------------------------------------------------
// block codes (spec: liquiddsp_tpu/ops/fec/block.py)
// ---------------------------------------------------------------------------

struct BlockCode {
  unsigned k, r;
  std::vector<uint8_t> p;  // k x r parity matrix
};

static void hamming_parity(unsigned k, unsigned r, BlockCode* c) {
  c->k = k; c->r = r;
  c->p.assign(k * r, 0);
  unsigned found = 0;
  for (unsigned v = 1; v < (1u << r) && found < k; v++) {
    if ((v & (v - 1)) == 0) continue;  // skip powers of two
    for (unsigned j = 0; j < r; j++) c->p[found * r + j] = (v >> j) & 1u;
    found++;
  }
}

static void secded(unsigned k, unsigned r, BlockCode* c) {
  BlockCode h; hamming_parity(k, r, &h);
  c->k = k; c->r = r + 1;
  c->p.assign(k * (r + 1), 0);
  for (unsigned i = 0; i < k; i++) {
    unsigned rowsum = 1;  // the data bit itself
    for (unsigned j = 0; j < r; j++) {
      c->p[i * (r + 1) + j] = h.p[i * r + j];
      rowsum += h.p[i * r + j];
    }
    c->p[i * (r + 1) + r] = rowsum & 1u;
  }
}

static void golay(BlockCode* c) {
  static const int qr[6] = {0, 1, 3, 4, 5, 9};
  c->k = 12; c->r = 12;
  c->p.assign(144, 0);
  for (int i = 0; i < 11; i++) {
    for (int j = 0; j < 11; j++) {
      int d = ((j - i) % 11 + 11) % 11;
      for (int q = 0; q < 6; q++)
        if (d == qr[q]) c->p[i * 12 + j] = 1;
    }
    c->p[i * 12 + 11] = 1;
  }
  for (int j = 0; j < 11; j++) c->p[11 * 12 + j] = 1;
}

static int get_code(unsigned outer, BlockCode* c) {
  // outer index space (reference lib/flex_tx_impl.cc:150-181)
  switch (outer) {
    case 1: golay(c); return 3;              // golay corrects 3
    case 3: hamming_parity(4, 3, c); return 1;
    case 4: hamming_parity(8, 4, c); return 1;
    case 5: secded(16, 5, c); return 1;
    case 6: secded(32, 6, c); return 1;
    case 7: secded(64, 7, c); return 1;
    default: return -1;
  }
}

int golden_block_encode(unsigned outer, const uint8_t* bits, unsigned nblocks,
                        uint8_t* out) {
  BlockCode c;
  if (get_code(outer, &c) < 0) return -1;
  for (unsigned b = 0; b < nblocks; b++) {
    const uint8_t* m = bits + b * c.k;
    uint8_t* o = out + b * (c.k + c.r);
    memcpy(o, m, c.k);
    for (unsigned j = 0; j < c.r; j++) {
      unsigned s = 0;
      for (unsigned i = 0; i < c.k; i++) s ^= m[i] & c.p[i * c.r + j];
      o[c.k + j] = (uint8_t)(s & 1u);
    }
  }
  return (int)(c.k + c.r);
}

int golden_block_decode(unsigned outer, const uint8_t* coded, unsigned nblocks,
                        uint8_t* out) {
  BlockCode c;
  int maxw = get_code(outer, &c);
  if (maxw < 0) return -1;
  unsigned n = c.k + c.r;  // may exceed 64 (secded7264: n=72) — byte masks
  // build syndrome table: syndrome -> error pattern (n bytes, weight<=maxw)
  std::vector<uint8_t> table((size_t)(1u << c.r) * n, 0);
  std::vector<uint8_t> filled(1u << c.r, 0);
  filled[0] = 1;
  auto syndrome_of = [&](const uint8_t* err) {
    unsigned s = 0;
    for (unsigned i = 0; i < c.k; i++)
      if (err[i])
        for (unsigned j = 0; j < c.r; j++)
          s ^= ((unsigned)c.p[i * c.r + j] & 1u) << j;
    for (unsigned j = 0; j < c.r; j++)
      if (err[c.k + j]) s ^= 1u << j;
    return s;
  };
  std::vector<uint8_t> err(n);
  for (int w = 1; w <= maxw; w++) {
    // odometer over combinations of n choose w
    std::vector<unsigned> pos(w);
    for (int i = 0; i < w; i++) pos[i] = i;
    while (true) {
      std::fill(err.begin(), err.end(), 0);
      for (int i = 0; i < w; i++) err[pos[i]] = 1;
      unsigned s = syndrome_of(err.data());
      if (!filled[s]) {
        memcpy(&table[(size_t)s * n], err.data(), n);
        filled[s] = 1;
      }
      // next combination
      int i = w - 1;
      while (i >= 0 && pos[i] == n - (unsigned)w + i) i--;
      if (i < 0) break;
      pos[i]++;
      for (int j2 = i + 1; j2 < w; j2++) pos[j2] = pos[j2 - 1] + 1;
    }
  }
  for (unsigned b = 0; b < nblocks; b++) {
    const uint8_t* cw = coded + b * n;
    unsigned s = syndrome_of(cw);
    const uint8_t* e = &table[(size_t)s * n];
    for (unsigned i = 0; i < c.k; i++)
      out[b * c.k + i] = (uint8_t)(cw[i] ^ e[i]);
  }
  return (int)c.k;
}

// ---------------------------------------------------------------------------
// convolutional K=7 + puncturing + hard Viterbi
// (spec: liquiddsp_tpu/ops/fec/conv.py; G0=0o133, G1=0o171)
// ---------------------------------------------------------------------------

static const unsigned G0 = 0133, G1 = 0171;

static void puncture_pattern(unsigned inner, std::vector<uint8_t>* p0,
                             std::vector<uint8_t>* p1) {
  switch (inner) {
    case 1: *p0 = {1}; *p1 = {1}; break;
    case 2: *p0 = {1, 1}; *p1 = {1, 0}; break;
    case 3: *p0 = {1, 1, 1, 1}; *p1 = {1, 0, 0, 0}; break;
    case 4: *p0 = {1, 0, 1, 0, 1}; *p1 = {1, 1, 0, 1, 0}; break;
    case 5: *p0 = {1, 1, 1, 1, 1, 1}; *p1 = {1, 0, 0, 0, 0, 0}; break;
    case 6: *p0 = {1, 0, 0, 0, 1, 0, 1}; *p1 = {1, 1, 1, 1, 0, 1, 0}; break;
  }
}

int golden_conv_encode(unsigned inner, const uint8_t* bits, unsigned nbits,
                       uint8_t* out) {
  if (inner == 0) { memcpy(out, bits, nbits); return (int)nbits; }
  std::vector<uint8_t> p0, p1;
  puncture_pattern(inner, &p0, &p1);
  unsigned period = (unsigned)p0.size();
  unsigned state = 0, pos = 0;
  unsigned steps = nbits + 6;
  for (unsigned t = 0; t < steps; t++) {
    unsigned u = (t < nbits) ? bits[t] : 0;
    unsigned reg = ((state << 1) | u) & 0x7F;
    unsigned c0 = __builtin_popcount(reg & G0) & 1u;
    unsigned c1 = __builtin_popcount(reg & G1) & 1u;
    if (p0[t % period]) out[pos++] = (uint8_t)c0;
    if (p1[t % period]) out[pos++] = (uint8_t)c1;
    state = reg & 0x3F;
  }
  return (int)pos;
}

int golden_viterbi_decode(unsigned inner, const uint8_t* coded, unsigned ncoded,
                          unsigned nbits, uint8_t* out) {
  if (inner == 0) { memcpy(out, coded, nbits); return (int)nbits; }
  std::vector<uint8_t> p0, p1;
  puncture_pattern(inner, &p0, &p1);
  unsigned period = (unsigned)p0.size();
  unsigned steps = nbits + 6;
  // depuncture into soft pairs: +1 (bit0) / -1 (bit1) / 0 (erased)
  std::vector<float> l0(steps, 0.f), l1(steps, 0.f);
  unsigned pos = 0;
  for (unsigned t = 0; t < steps; t++) {
    if (p0[t % period]) { if (pos < ncoded) l0[t] = coded[pos] ? -1.f : 1.f; pos++; }
    if (p1[t % period]) { if (pos < ncoded) l1[t] = coded[pos] ? -1.f : 1.f; pos++; }
  }
  // expected outputs per (state, input)
  float e0[64][2], e1[64][2];
  for (unsigned s = 0; s < 64; s++)
    for (unsigned u = 0; u < 2; u++) {
      unsigned reg = ((s << 1) | u) & 0x7F;
      e0[s][u] = (__builtin_popcount(reg & G0) & 1) ? -1.f : 1.f;
      e1[s][u] = (__builtin_popcount(reg & G1) & 1) ? -1.f : 1.f;
    }
  const float NEG = -1e30f;
  std::vector<float> metric(64, NEG), next(64);
  metric[0] = 0.f;
  std::vector<uint8_t> decisions(steps * 64);
  for (unsigned t = 0; t < steps; t++) {
    for (unsigned sp = 0; sp < 64; sp++) {
      unsigned u = sp & 1;
      unsigned pA = sp >> 1, pB = (sp >> 1) | 32;
      float cA = metric[pA] + l0[t] * e0[pA][u] + l1[t] * e1[pA][u];
      float cB = metric[pB] + l0[t] * e0[pB][u] + l1[t] * e1[pB][u];
      if (cB > cA) { next[sp] = cB; decisions[t * 64 + sp] = 1; }
      else { next[sp] = cA; decisions[t * 64 + sp] = 0; }
    }
    metric = next;
  }
  unsigned state = 0;  // terminated
  std::vector<uint8_t> bits(steps);
  for (int t = (int)steps - 1; t >= 0; t--) {
    bits[t] = state & 1;
    unsigned d = decisions[t * 64 + state];
    state = (state >> 1) | (d ? 32u : 0u);
  }
  memcpy(out, bits.data(), nbits);
  return (int)nbits;
}

// ---------------------------------------------------------------------------
// Reed-Solomon (255,223) over GF(2^8)/0x11D, fcr=1
// (spec: liquiddsp_tpu/ops/fec/rs.py)
// ---------------------------------------------------------------------------

struct GF {
  uint8_t exp[512];
  uint8_t logt[256];
  GF() {
    unsigned x = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = (uint8_t)x;
      logt[x] = (uint8_t)i;
      x <<= 1;
      if (x & 0x100) x ^= 0x11D;
    }
    for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
    logt[0] = 0;
  }
  uint8_t mul(uint8_t a, uint8_t b) const {
    if (!a || !b) return 0;
    return exp[logt[a] + logt[b]];
  }
  uint8_t inv(uint8_t a) const { return exp[255 - logt[a]]; }
};
static const GF gf;

static void rs_genpoly(uint8_t* g /*33, ascending*/) {
  memset(g, 0, 33);
  g[0] = 1;
  for (int i = 1; i <= 32; i++) {
    uint8_t root = gf.exp[i];
    uint8_t prev = 0;
    for (int d = 0; d <= 32; d++) {
      uint8_t cur = g[d];
      g[d] = gf.mul(cur, root) ^ prev;
      prev = cur;
    }
  }
}

void golden_rs_encode_block(const uint8_t* msg, unsigned k, uint8_t* out) {
  uint8_t g[33];
  rs_genpoly(g);
  uint8_t parity[32];
  memset(parity, 0, 32);
  for (unsigned i = 0; i < k; i++) {
    uint8_t fb = msg[i] ^ parity[31];
    for (int j = 31; j > 0; j--) parity[j] = parity[j - 1] ^ gf.mul(fb, g[j]);
    parity[0] = gf.mul(fb, g[0]);
  }
  memcpy(out, msg, k);
  for (int j = 0; j < 32; j++) out[k + j] = parity[31 - j];
}

int golden_rs_decode_block(const uint8_t* code, unsigned k, uint8_t* out) {
  unsigned n = k + 32;
  uint8_t syn[32];
  bool any = false;
  for (int i = 0; i < 32; i++) {
    uint8_t s = 0;
    for (unsigned j = 0; j < n; j++) s = gf.mul(s, gf.exp[i + 1]) ^ code[j];
    syn[i] = s;
    if (s) any = true;
  }
  if (!any) { memcpy(out, code, k); return 0; }
  // Berlekamp-Massey
  uint8_t C[33], B[33];
  memset(C, 0, 33); memset(B, 0, 33);
  C[0] = B[0] = 1;
  unsigned L = 0, mshift = 1;
  uint8_t b = 1;
  for (unsigned i = 0; i < 32; i++) {
    uint8_t d = 0;
    for (unsigned j = 0; j <= L; j++)
      if (j <= i) d ^= gf.mul(C[j], syn[i - j]);
    if (d == 0) { mshift++; continue; }
    uint8_t coef = gf.mul(d, gf.inv(b));
    uint8_t T[33]; memcpy(T, C, 33);
    for (unsigned j = 0; j + mshift <= 32; j++)
      C[j + mshift] ^= gf.mul(coef, B[j]);
    if (2 * L <= i) { L = i + 1 - L; memcpy(B, T, 33); b = d; mshift = 1; }
    else mshift++;
  }
  if (L > 16) { memcpy(out, code, k); return -1; }
  // Chien + Forney over the n positions (jp counted from last byte)
  uint8_t omega[32];
  for (int d = 0; d < 32; d++) {
    uint8_t s = 0;
    for (int j = 0; j <= d && j <= 32; j++)
      if (d - j < 32) s ^= gf.mul(syn[d - j], C[j]);
    omega[d] = s;
  }
  std::vector<uint8_t> fixed(code, code + n);
  int nerr = 0;
  for (unsigned jp = 0; jp < n; jp++) {
    // X^{-1} = alpha^{-jp}
    uint8_t lam = 0;
    for (unsigned d = 0; d <= 32; d++) {
      unsigned e = (unsigned)((255 - ((jp * d) % 255)) % 255);
      lam ^= gf.mul(C[d], gf.exp[e]);
    }
    if (lam) continue;
    // error at position n-1-jp; magnitude = Omega(Xinv)/Lambda'(Xinv)
    uint8_t ov = 0, dv = 0;
    for (unsigned d = 0; d < 32; d++) {
      unsigned e = (unsigned)((255 - ((jp * d) % 255)) % 255);
      ov ^= gf.mul(omega[d], gf.exp[e]);
    }
    for (unsigned d = 1; d <= 32; d += 2) {
      unsigned e = (unsigned)((255 - ((jp * (d - 1)) % 255)) % 255);
      dv ^= gf.mul(C[d], gf.exp[e]);
    }
    if (!dv) { memcpy(out, code, k); return -1; }
    fixed[n - 1 - jp] ^= gf.mul(ov, gf.inv(dv));
    nerr++;
  }
  memcpy(out, fixed.data(), k);
  return nerr;
}

}  // extern "C"
