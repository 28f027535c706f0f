// Host prep of an ed25519 batch for the verify kernels, in one C pass.
//
// Counterpart of ed25519_prep in the JAX package's native module
// (native/_native.cpp:187-463), with a plain C interface and no Python
// object anywhere: ops/_build.py compiles this file with g++ into a
// host library of its own, and ops/ed25519.py calls it through ctypes,
// which drops the GIL for the call.  Per item it does the length check
// (carried in from the caller as bad_len), the canonical-S check,
// k = SHA-512(R || A || msg) mod L and the 4-bit window split of s and
// k, straight into the caller's buffers:
//   a_out, r_out  [m, 32] uint8 (padding and rejected lanes: B, identity)
//   sw_out, kw_out [m, 64] uint8 4-bit windows, lane-major (zero on
//                  padding and rejected lanes)
//   bad_out       [m] uint8 (1 = malformed or non-canonical S)
// Inputs are the packed blobs of ops/ed25519.pack: pubs 32n, sigs 64n,
// the messages concatenated with n+1 offsets, and a bad-length byte per
// item (whose pub and sig are zero placeholders in the blobs).
//
// Messages hash eight at a time in AVX-512 lanes (sha512_mb.hpp), in
// groups of equal block count; longer than 128 blocks, or without
// AVX-512 (checked at run time), they hash one at a time.  Lanes split
// across at most 8 threads, and one thread below 2,048 items.

#include <cstdint>
#include <cstring>
#include <functional>
#include <system_error>
#include <thread>
#include <vector>

#include "sha512.hpp"
#include "sha512_mb.hpp"

namespace {

struct ItemRef {
  const uint8_t* pub;
  const uint8_t* msg;
  size_t msglen;
  const uint8_t* sig;
  bool bad;
};

// L little-endian, for the canonical-S check
const uint8_t L_LE[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58,
    0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10,
};

constexpr int kMaxThreads = 8;
constexpr int64_t kThreadedFrom = 2048;
constexpr size_t kMaxMbBlocks = 128;     // > 16 KiB messages go scalar

inline void write_windows(uint8_t* row, const uint8_t le[32]) {
  for (int b = 0; b < 32; b++) {
    row[2 * b] = le[b] & 0x0F;
    row[2 * b + 1] = le[b] >> 4;
  }
}

inline void k_windows_from_digest(const uint8_t digest[64], uint8_t* kw8,
                                  int64_t lane) {
  uint8_t k_le[32];
  sha512::reduce_mod_l(digest, k_le);
  write_windows(kw8 + lane * 64, k_le);
}

#if COMETBFT_SHA512MB_X86
// pending 8-lane group of equal-block-count messages
struct KGroup {
  size_t nblocks = 0;
  int n = 0;
  int64_t lane[8];
  const ItemRef* item[8];
};

void flush_group(KGroup& g, std::vector<uint8_t>& scratch, uint8_t* kw8) {
  if (g.n == 0) return;
  size_t slot = g.nblocks * 128;
  scratch.assign(slot * 8, 0);
  const uint8_t* base[8];
  for (int l = 0; l < 8; l++) {
    if (l < g.n) {
      uint8_t* buf = scratch.data() + size_t(l) * slot;
      const ItemRef* it = g.item[l];
      std::memcpy(buf, it->sig, 32);
      std::memcpy(buf + 32, it->pub, 32);
      if (it->msglen) std::memcpy(buf + 64, it->msg, it->msglen);
      sha512mb::write_padding(buf, 64 + it->msglen, g.nblocks);
      base[l] = buf;
    } else {
      base[l] = scratch.data();         // pad the group with lane 0
    }
  }
  uint8_t digests[8][64];
  sha512mb::hash8(base, g.nblocks, digests);
  for (int l = 0; l < g.n; l++)
    k_windows_from_digest(digests[l], kw8, g.lane[l]);
  g.n = 0;
}
#endif

// lanes [lo, hi): canonical-S, row copies, SHA-512, windows
void lanes(const ItemRef* refs, int64_t lo, int64_t hi, uint8_t* a_p,
           uint8_t* r_p, uint8_t* sw8, uint8_t* kw8, uint8_t* bad_p) {
#if COMETBFT_SHA512MB_X86
  const bool use_mb = sha512mb::available();
  // groups keyed by block count (a commit's sign bytes are nearly
  // always of one length, so this stays tiny)
  std::vector<KGroup> groups;
  std::vector<uint8_t> scratch;
#endif
  for (int64_t i = lo; i < hi; i++) {
    const ItemRef& it = refs[i];
    if (it.bad) {
      bad_p[i] = 1;
      continue;
    }
    const uint8_t* s_le = it.sig + 32;
    bool lt = false;
    for (int b = 31; b >= 0; b--) {
      if (s_le[b] != L_LE[b]) {
        lt = s_le[b] < L_LE[b];
        break;
      }
    }
    if (!lt) {                          // s >= L: non-canonical
      bad_p[i] = 1;
      continue;
    }
    std::memcpy(a_p + i * 32, it.pub, 32);
    std::memcpy(r_p + i * 32, it.sig, 32);
    write_windows(sw8 + i * 64, s_le);
#if COMETBFT_SHA512MB_X86
    if (use_mb) {
      size_t nb = sha512mb::block_count(64 + it.msglen);
      if (nb <= kMaxMbBlocks) {
        KGroup* g = nullptr;
        for (auto& cand : groups)
          if (cand.nblocks == nb) { g = &cand; break; }
        if (!g) {
          groups.emplace_back();
          g = &groups.back();
          g->nblocks = nb;
        }
        g->lane[g->n] = i;
        g->item[g->n] = &it;
        if (++g->n == 8) flush_group(*g, scratch, kw8);
        continue;
      }
    }
#endif
    sha512::Ctx c;
    sha512::init(&c);
    sha512::update(&c, it.sig, 32);
    sha512::update(&c, it.pub, 32);
    sha512::update(&c, it.msg, it.msglen);
    uint8_t digest[64];
    sha512::final(&c, digest);
    k_windows_from_digest(digest, kw8, i);
  }
#if COMETBFT_SHA512MB_X86
  for (auto& g : groups) flush_group(g, scratch, kw8);
#endif
}

int thread_count(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = hw > kMaxThreads ? kMaxThreads : (hw ? int(hw) : 1);
  return n < kThreadedFrom ? 1 : nt;
}

void run_threads(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  int nt = thread_count(n);
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = int64_t(t) * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    try {
      ts.emplace_back(fn, lo, hi);
    } catch (const std::system_error&) {
      fn(lo, hi);                       // no thread to be had: run here
    }
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// 0 on success; 1 if m < n or an offset runs backwards; 2 if the pass
// itself failed (out of memory).  The outputs are undefined unless 0.
int ed25519_prep(const uint8_t* pubs, const uint8_t* sigs,
                 const uint8_t* msgs, const int64_t* offsets,
                 const uint8_t* bad_len, int64_t n, int64_t m,
                 const uint8_t* b_bytes, const uint8_t* id_bytes,
                 uint8_t* a_out, uint8_t* r_out, uint8_t* sw_out,
                 uint8_t* kw_out, uint8_t* bad_out) {
  if (n < 0 || m < n) return 1;
  try {
    std::vector<ItemRef> refs(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) {
      if (offsets[i + 1] < offsets[i]) return 1;
      refs[i] = {pubs + i * 32, msgs + offsets[i],
                 size_t(offsets[i + 1] - offsets[i]), sigs + i * 64,
                 bad_len[i] != 0};
    }
    // padding defaults: lanes not written below verify trivially
    // (0·B - identity - 0·B == identity) and their windows are zero
    std::memset(sw_out, 0, size_t(64) * size_t(m));
    std::memset(kw_out, 0, size_t(64) * size_t(m));
    std::memset(bad_out, 0, size_t(m));
    for (int64_t i = 0; i < m; i++) {
      std::memcpy(a_out + i * 32, b_bytes, 32);
      std::memcpy(r_out + i * 32, id_bytes, 32);
    }
    const ItemRef* refp = refs.data();
    run_threads(n, [&](int64_t lo, int64_t hi) {
      lanes(refp, lo, hi, a_out, r_out, sw_out, kw_out, bad_out);
    });
  } catch (const std::bad_alloc&) {
    return 2;
  }
  return 0;
}

// Threads ed25519_prep runs for n items.
int ed25519_prep_threads(int64_t n) { return thread_count(n); }

// 1 if this CPU hashes eight messages at once (AVX-512F), else 0.
int ed25519_prep_multibuffer(void) { return sha512mb::available() ? 1 : 0; }

}  // extern "C"
