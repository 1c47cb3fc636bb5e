// aios_native — C++ runtime primitives for the aiOS-TPU service plane.
//
// The reference implements its service plane in Rust (tools/src, memory/src);
// this library provides the equivalent native hot-path primitives for the
// Python services, exported over a C ABI for ctypes:
//
//   * a fixed-capacity MPMC event ring buffer (operational memory tier,
//     reference memory/src/operational.rs — <1 ms access target),
//   * monotonic token buckets (tool rate limiting, tools/src/executor.rs
//     52-104),
//   * a self-contained SHA-256 + hash-chain step (audit ledger,
//     tools/src/audit.rs:54-104).
//
// Build: scripts in ../build.py invoke g++ -O2 -shared -fPIC.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), self-contained
// ---------------------------------------------------------------------------

namespace sha256 {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

struct Ctx {
  uint32_t h[8];
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Ctx() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
  }

  void block(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
             (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t len) {
    total += len;
    while (len > 0) {
      size_t take = 64 - buflen;
      if (take > len) take = len;
      memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      len -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenbuf[8];
    for (int i = 0; i < 8; i++) lenbuf[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenbuf, 8);
    for (int i = 0; i < 8; i++) {
      out[i * 4] = uint8_t(h[i] >> 24);
      out[i * 4 + 1] = uint8_t(h[i] >> 16);
      out[i * 4 + 2] = uint8_t(h[i] >> 8);
      out[i * 4 + 3] = uint8_t(h[i]);
    }
  }
};

static void hex(const uint8_t* digest, char* out) {
  static const char* digits = "0123456789abcdef";
  for (int i = 0; i < 32; i++) {
    out[i * 2] = digits[digest[i] >> 4];
    out[i * 2 + 1] = digits[digest[i] & 0xf];
  }
  out[64] = '\0';
}

}  // namespace sha256

extern "C" {

// out must hold >= 65 bytes
void aios_sha256_hex(const uint8_t* data, uint64_t len, char* out) {
  sha256::Ctx ctx;
  ctx.update(data, len);
  uint8_t digest[32];
  ctx.final(digest);
  sha256::hex(digest, out);
}

// One audit-chain step: hash(prev_hex || payload) -> hex.
void aios_chain_hash(const char* prev_hex, const uint8_t* payload,
                     uint64_t payload_len, char* out) {
  sha256::Ctx ctx;
  ctx.update(reinterpret_cast<const uint8_t*>(prev_hex), strlen(prev_hex));
  ctx.update(payload, payload_len);
  uint8_t digest[32];
  ctx.final(digest);
  sha256::hex(digest, out);
}

// ---------------------------------------------------------------------------
// Event ring buffer (operational memory tier)
// ---------------------------------------------------------------------------

struct Ring {
  std::mutex mu;
  std::deque<std::vector<uint8_t>> items;
  size_t capacity;
  uint64_t total_pushed = 0;
};

void* aios_ring_create(uint64_t capacity) {
  Ring* r = new Ring();
  r->capacity = capacity ? capacity : 1;
  return r;
}

void aios_ring_destroy(void* handle) { delete static_cast<Ring*>(handle); }

void aios_ring_push(void* handle, const uint8_t* data, uint64_t len) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  r->items.emplace_back(data, data + len);
  r->total_pushed++;
  while (r->items.size() > r->capacity) r->items.pop_front();
}

uint64_t aios_ring_size(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  return r->items.size();
}

uint64_t aios_ring_total(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  return r->total_pushed;
}

// Copy the i-th most recent item (0 = newest) into out; returns its length,
// 0 if absent, or the required size if out_cap is too small.
// Returns the item's size (0 is a valid empty item; copy happens only when
// it fits out_cap) or -1 when `index` is beyond the ring — a distinct
// sentinel so empty events are not mistaken for end-of-ring.
int64_t aios_ring_get_recent(void* handle, uint64_t index, uint8_t* out,
                             uint64_t out_cap) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  if (index >= r->items.size()) return -1;
  const auto& item = r->items[r->items.size() - 1 - index];
  if (item.size() > out_cap) return static_cast<int64_t>(item.size());
  memcpy(out, item.data(), item.size());
  return static_cast<int64_t>(item.size());
}

// ---------------------------------------------------------------------------
// Token bucket (rate limiting)
// ---------------------------------------------------------------------------

struct Bucket {
  std::mutex mu;
  double rate;
  double capacity;
  double tokens;
  std::chrono::steady_clock::time_point updated;
};

void* aios_bucket_create(double rate, double capacity) {
  Bucket* b = new Bucket();
  b->rate = rate;
  b->capacity = capacity > 0 ? capacity : rate;
  b->tokens = b->capacity;
  b->updated = std::chrono::steady_clock::now();
  return b;
}

void aios_bucket_destroy(void* handle) { delete static_cast<Bucket*>(handle); }

int aios_bucket_try_acquire(void* handle, double n) {
  Bucket* b = static_cast<Bucket*>(handle);
  std::lock_guard<std::mutex> lock(b->mu);
  auto now = std::chrono::steady_clock::now();
  double elapsed = std::chrono::duration<double>(now - b->updated).count();
  b->updated = now;
  b->tokens = std::min(b->capacity, b->tokens + elapsed * b->rate);
  if (b->tokens >= n) {
    b->tokens -= n;
    return 1;
  }
  return 0;
}

double aios_bucket_tokens(void* handle) {
  Bucket* b = static_cast<Bucket*>(handle);
  std::lock_guard<std::mutex> lock(b->mu);
  return b->tokens;
}

}  // extern "C"
