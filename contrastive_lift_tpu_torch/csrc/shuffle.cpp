// numpy's Generator.permutation(n), drawn on the caller's PCG64 stream.
//
// For each of a list of sizes n, in order, this does what
// `rng.permutation(n)` does and keeps the first `keep` indices: it draws the
// same 32-bit numbers in the same order, and hands back the generator's state
// after the last of them, so numpy can go on drawing from it. What numpy
// does (random/_generator.pyx `shuffle`, distributions.c `random_interval`,
// pcg64.h `pcg64_next32`):
//   x = arange(n); for i = n-1 down to 1: j = random_interval(i), swap x[i]
//   and x[j];
//   random_interval(i): mask = the smallest 2^k - 1 >= i; draw 32-bit values
//   until (value & mask) <= i (i < 2^32; the caller keeps n < 2^31);
//   next32: the pending high half if `has_uint32`, else one PCG64 step, whose
//   low half is returned and whose high half is kept (`uinteger`, set on
//   every step even when it is used at once, `has_uint32` = 1);
//   the step: state = state * MULT + inc (mod 2^128), output
//   rotr64(hi ^ lo, state >> 122).
//
// Faster than numpy's for three reasons: the steps are made ahead of the
// shuffle, a block at a time, on two interleaved chains; the accept test
// takes no branch (a rejected draw swaps x[i] with itself); and positions at
// or past `keep` are never read once their index is passed, so there a swap
// is one store. Built with plain g++ (no OpenMP): the draws are serial.
//
// Entry point (C ABI, ctypes): see `pcg64_permutation_heads` at the end.
#include <cstdint>
#include <cstdlib>

namespace {

typedef unsigned __int128 u128;

const u128 MULT = ((u128)0x2360ED051FC65DA4ULL << 64) | 0x4385DF649FCCF645ULL;
const int64_t STEPS = 256;  // PCG64 steps made ahead at a time (even)

inline uint64_t output(u128 s) {
  uint64_t hi = (uint64_t)(s >> 64);
  uint64_t x = hi ^ (uint64_t)s;
  unsigned rot = (unsigned)(hi >> 58);
  return (x >> rot) | (x << ((64 - rot) & 63));
}

// numpy's 32-bit draws, in order. `buf[pos:len]` are the draws not yet used.
// A block of steps fills `buf` with each step's low then high half; before
// the first block, `buf` holds the half pending in the generator, if any.
struct Draws {
  u128 state;          // the state before the block's first step
  u128 inc;
  u128 ahead;          // the state after the block's last step
  uint32_t uinteger;   // numpy's `uinteger` before the first block
  bool steps;          // `buf` holds a block of steps
  int64_t pos, len;
  uint32_t buf[2 * STEPS];

  Draws(const uint64_t* st) {
    state = ahead = ((u128)st[0] << 64) | st[1];
    inc = ((u128)st[2] << 64) | st[3];
    uinteger = (uint32_t)st[5];
    steps = false;
    pos = 0;
    len = st[4] ? 1 : 0;
    buf[0] = uinteger;
  }

  // The next block, once every draw of this one is used.
  void refill() {
    state = ahead;
    // two chains, s_k and s_{k+1}, each stepped twice at a time: the
    // multiplications of one overlap the other's
    const u128 mult2 = MULT * MULT, inc2 = inc * (MULT + 1);
    u128 a = state * MULT + inc, b = a * MULT + inc;
    for (int64_t k = 0; k < STEPS; k += 2) {
      uint64_t oa = output(a), ob = output(b);
      buf[2 * k] = (uint32_t)oa;
      buf[2 * k + 1] = (uint32_t)(oa >> 32);
      buf[2 * k + 2] = (uint32_t)ob;
      buf[2 * k + 3] = (uint32_t)(ob >> 32);
      ahead = b;
      a = a * mult2 + inc2;
      b = b * mult2 + inc2;
    }
    steps = true;
    pos = 0;
    len = 2 * STEPS;
  }

  // The generator's state as numpy would hold it after the draws used.
  void finish(uint64_t* st) const {
    u128 s = state;
    uint64_t has = 0;
    uint32_t u = uinteger;
    if (!steps) {
      has = (uint64_t)(len - pos);  // the pending half, if any, is unused
    } else {
      // a block is made only for a draw, so pos >= 1: the steps used, and
      // the high half of the last (pending if the low half was the last
      // draw used)
      for (int64_t k = 0; k < (pos + 1) / 2; k++) s = s * MULT + inc;
      has = (uint64_t)(pos & 1);
      u = buf[has ? pos : pos - 1];
    }
    st[0] = (uint64_t)(s >> 64);
    st[1] = (uint64_t)s;
    st[4] = has;
    st[5] = u;
  }
};

// x = arange(n), shuffled as numpy does; only x[0:keep] is exact.
void shuffle(Draws& d, uint32_t n, uint32_t keep, int32_t* x) {
  for (uint32_t k = 0; k < n; k++) x[k] = (int32_t)k;
  if (n < 2) return;
  uint32_t i = n - 1;
  while (i >= 1) {
    const uint32_t top = 1u << (31 - __builtin_clz(i));
    const uint32_t mask = top | (top - 1);
    const bool past = i >= keep;  // x[i] is not read again once i is passed
    const uint32_t lo = past && keep > top ? keep : top;
    while (i >= lo) {
      if (d.pos == d.len) d.refill();
      // each draw lowers i by at most one, so these stay within [lo, i]
      int64_t m = d.len - d.pos;
      if (m > (int64_t)(i - lo + 1)) m = i - lo + 1;
      const uint32_t* b = d.buf + d.pos;
      if (past) {
        for (int64_t k = 0; k < m; k++) {
          // a rejected draw stores to x[n], which is never read: masks, so
          // that the compiler makes no branch of it
          const uint32_t v = b[k] & mask;
          const uint32_t no = 0u - (uint32_t)(v > i);
          x[v ^ ((v ^ n) & no)] = x[i];
          i -= 1 + no;
        }
      } else {
        for (int64_t k = 0; k < m; k++) {
          const uint32_t v = b[k] & mask;
          const uint32_t ok = v <= i;
          const uint32_t j = ok ? v : i;
          const int32_t t = x[j];
          x[j] = x[i];
          x[i] = t;
          i -= ok;
        }
      }
      d.pos += m;
    }
  }
}

}  // namespace

extern "C" {

// For each sizes[c] (0 <= sizes[c] < 2^31), c < count, in order: numpy's
// permutation of arange(sizes[c]), its first min(sizes[c], keep) indices in
// out[c * keep ...]. `st` is the PCG64 state, read and then written back as
// numpy would hold it after the same draws: {state >> 64, state & (2^64-1),
// inc >> 64, inc & (2^64-1), has_uint32, uinteger}. Returns 0, or -1 for a
// size out of range or no memory (then nothing is drawn or written).
int pcg64_permutation_heads(uint64_t* st, const int64_t* sizes, int64_t count,
                            int64_t keep, int64_t* out) {
  int64_t most = 1;
  for (int64_t c = 0; c < count; c++) {
    if (sizes[c] < 0 || sizes[c] >= ((int64_t)1 << 31)) return -1;
    if (sizes[c] > most) most = sizes[c];
  }
  if (keep < 0) return -1;
  int32_t* x = (int32_t*)malloc(sizeof(int32_t) * (most + 1));
  if (!x) return -1;
  Draws d(st);
  const uint32_t k32 = keep < most ? (uint32_t)keep : (uint32_t)most;
  for (int64_t c = 0; c < count; c++) {
    const uint32_t n = (uint32_t)sizes[c];
    shuffle(d, n, k32, x);
    const uint32_t k = n < k32 ? n : k32;
    for (uint32_t q = 0; q < k; q++) out[c * keep + q] = x[q];
  }
  d.finish(st);
  free(x);
  return 0;
}

}  // extern "C"
