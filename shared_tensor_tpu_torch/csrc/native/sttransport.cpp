// sttransport: native host transport for shared-tensor-tpu.
//
// TPU-native re-design of the reference's communication layers (the 477-line
// C module's L1 robust I/O, L3 link engines, L4 tree topology — see SURVEY.md
// §1; reference src/sharedtensor.c:53-104, :113-189, :192-332). The codec
// math itself lives on the TPU (Pallas kernels); this library owns only the
// wire: the self-organizing binary-tree overlay, framed full-duplex streaming
// per link, join/redirect membership, bandwidth pacing, liveness, and
// metrics. Frames are opaque byte payloads to this layer.
//
// Deliberate fixes over the reference (SURVEY.md Appendix A):
//  - any socket error tears down ONE link and emits an event instead of
//    exit(-1) for the whole process (quirks Q8; README.md:33 TODO);
//  - a dropped uplink re-joins through the rendezvous automatically;
//  - outgoing bandwidth can be capped per link (token bucket; README.md:31);
//  - configurable listen backlog (Q10), clean shutdown for connected nodes.
//
// Two wire modes:
//  - native (default): length-prefixed frames [u32le len][payload]; len==0 is
//    a keepalive. Join handshake: client sends "STT3" + u32le payload_hint;
//    server replies 'Y' (accept) or 'N' + 16-byte IPv4 sockaddr redirect.
//  - wire-compat: byte-exact reference protocol for interop with C peers
//    (SURVEY.md §2.3): no hello, fixed-size frames [f32 scale][ceil(n/8) bit
//    mask], join reply 'Y' / 'N'+sockaddr, idle links emit one zero-scale
//    frame per second (reference quirk Q2 behavior, required for liveness).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <arpa/inet.h>
#include <fcntl.h>
#include <linux/futex.h>
#include <signal.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>

// ST_ANALYZE_NO_SIMD: the clang front-end analyzer (-Wthread-safety,
// tools/analyze_clang.py) cannot parse gcc's intrinsics headers; it
// analyzes the scalar reference paths instead. Never set by any build.
#if defined(__x86_64__) && defined(__SSE2__) && !defined(ST_ANALYZE_NO_SIMD)
#include <emmintrin.h>  // NT stores for the shm ring bulk copies
#endif

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "st_annotations.h"  // clang -Wthread-safety vocabulary (no-op on gcc)
#include "st_cv.h"           // system-clock condvar deadlines (TSan arm)

// Process-wide crash point (ST_FAULT_CRASH="name:N"): _exit(17) on the Nth
// arrival at the named point. Parsed once; thread-safe countdown. Defined
// ONCE for the whole .so and shared with stengine.cpp's protocol points
// (mid-burst, between-apply-and-ack) — a per-translation-unit copy would
// split the parse/countdown state, so a point name served by both files
// would fire at the wrong Nth arrival.
extern "C" __attribute__((visibility("default"))) void st_fault_crash_point(
    const char* name) {
  // Hot path first: every engine/transport data loop in the process calls
  // this per message, so the UNARMED case (production default) must be a
  // single relaxed atomic load — never the shared mutex, which would be a
  // process-global serialization point across all nodes' threads.
  static std::atomic<int> armed{-1};  // -1 unparsed, 0 unarmed, 1 armed
  int a = armed.load(std::memory_order_relaxed);
  if (a == 0) return;
  static StMutex mu;
  static std::string point;    // under mu (function-locals cannot carry
  static long remaining = 0;   // ST_GUARDED_BY; the guard below is the law)
  StLockGuard lk(mu);
  if (armed.load(std::memory_order_relaxed) < 0) {
    const char* env = getenv("ST_FAULT_CRASH");
    if (env && *env) {
      std::string s(env);
      size_t c = s.find(':');
      point = c == std::string::npos ? s : s.substr(0, c);
      remaining = c == std::string::npos ? 1 : atol(s.c_str() + c + 1);
      if (remaining < 1) remaining = 1;
    }
    armed.store(point.empty() ? 0 : 1, std::memory_order_relaxed);
  }
  if (point.empty() || point != name) return;
  if (--remaining <= 0) _exit(17);
}

// ---- obs event ring (r08 tentpole) ---------------------------------------
//
// Lock-free per-thread rings of 32-byte timestamped protocol events, the
// native half of the cross-tier timeline (shared_tensor_tpu/obs/events.py
// defines the code names; the numeric codes here are ABI). Design:
//
//  - each EMITTING thread owns one SPSC ring (thread_local holder): the
//    writer touches only its own head (release store), the drainer only
//    tails (release store) — no locks, no CAS on the hot path. A full
//    ring DROPS the event and counts the drop (g_dropped), so a stalled
//    drainer degrades accounting, never the data plane.
//  - rings are registered in a global list under a mutex taken only at
//    thread birth and at drain time (both rare); rings are never freed —
//    a ring whose thread exited is marked retired and re-adopted by the
//    next new thread after its leftover events drain.
//  - timestamps are CLOCK_MONOTONIC ns, the same clock CPython's
//    time.monotonic_ns() reads on Linux, so native and Python events merge
//    by plain sort (st_obs_now_ns exports the clock for agreement checks).
//  - ST_OBS=0 in the environment (or st_obs_set_enabled(0)) turns emission
//    into one relaxed atomic load — the production-off cost.
//
// Shared with stengine.cpp (which imports st_obs_emit/st_node_obs_id):
// defined ONCE here for the same reason as st_fault_crash_point above.
namespace stobs {

constexpr uint32_t kEvRingCap = 2048;  // events per thread ring

struct EventRec {  // the 32-byte drain ABI record (obs/events.py _EVENT_FMT)
  uint64_t t_ns;
  uint32_t node_id;
  uint32_t code;
  int32_t link;
  uint32_t reserved;
  uint64_t arg;
};
static_assert(sizeof(EventRec) == 32, "obs event record is 32-byte ABI");

struct Ring {
  std::atomic<uint64_t> head{0};  // writer-owned
  std::atomic<uint64_t> tail{0};  // drainer-owned
  std::atomic<bool> live{false};  // owned by a running thread
  EventRec ev[kEvRingCap];
};

StMutex g_reg_mu;            // ring registration + drain (rare paths only)
// never freed; retired rings are re-adopted (ring INTERNALS are the SPSC
// head/tail atomics — only the list itself needs the registration mutex)
std::vector<Ring*> g_rings ST_GUARDED_BY(g_reg_mu);
std::atomic<int> g_enabled{[] {
  const char* e = getenv("ST_OBS");
  return (e && e[0] == '0' && !e[1]) ? 0 : 1;
}()};
std::atomic<uint64_t> g_dropped{0};
// Node obs ids must be unique across the PROCESSES of a loopback cluster,
// not just within one — the r09 digest keys its per-node breakdown and the
// trace context keys update origins on this id. Layout: 12 pid bits +
// 12 local bits = 24 bits, EXACTLY the origin field the trace record
// packs (origin << 8 | hop in a u32) — the local counter wraps INSIDE its
// pid block so an id can never exceed 2^24 (a spill past it would be
// silently truncated in every trace event, conflating origins). 4096
// nodes per process before in-block reuse; a long pytest session creates
// hundreds, not thousands. Cross-process risk left: two pids equal mod
// 4096 in ONE tree (1/4096 per pair — accepted, documented).
//
// This copy counts its local part DOWN from 0xFFF. A process may load the
// JAX package's transport build beside this one (a mixed tree, a JAX shard
// master with a port owner): that build has a counter of its own, which
// counts UP from 1 under the same pid block. Counting from both ends, the
// two never hand out the same id while the process has made at most 4095
// nodes of both builds together. Counting up from 1 here too, the first
// node of each would take the same id, and a shard plane that keys
// ownership by it would forward nothing to the other node.
std::atomic<uint32_t> g_next_node_local{0};
const uint32_t g_node_id_base = ((uint32_t)getpid() & 0xFFFu) << 12;

inline uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Thread-local ring ownership: adopt a retired ring (its undrained tail is
// preserved) or register a fresh one; retire at thread exit. Registration
// is once per thread lifetime — never on the emit path.
struct RingHolder {
  Ring* r;
  RingHolder() {
    StLockGuard lk(g_reg_mu);
    for (Ring* cand : g_rings) {
      // acquire pairs with the dead owner's release store in ~RingHolder:
      // the adopter must observe the old thread's final head/record
      // stores before writing its own events, or a stale head could
      // overwrite undrained records (a relaxed load has no such edge)
      if (!cand->live.load(std::memory_order_acquire)) {
        cand->live.store(true, std::memory_order_relaxed);
        r = cand;
        return;
      }
    }
    r = new Ring();
    r->live.store(true, std::memory_order_relaxed);
    g_rings.push_back(r);
  }
  ~RingHolder() { r->live.store(false, std::memory_order_release); }
};

// event codes (ABI; obs/events.py CODE_NAMES is the authoritative mirror).
// 1..4 reuse the membership Event kinds verbatim.
// maybe_unused: several are ABI documentation — the emit sites build the
// code inline (clang's -Wunused-const-variable would flag them).
[[maybe_unused]] constexpr uint32_t kEvRetransmit = 10;
[[maybe_unused]] constexpr uint32_t kEvBlackhole = 11;
[[maybe_unused]] constexpr uint32_t kEvQuarantine = 12;
[[maybe_unused]] constexpr uint32_t kEvWindowStall = 13;
[[maybe_unused]] constexpr uint32_t kEvDedupDiscard = 14;
[[maybe_unused]] constexpr uint32_t kEvSeal = 15;
constexpr uint32_t kEvFaultDrop = 20;
constexpr uint32_t kEvFaultDup = 21;
constexpr uint32_t kEvFaultCorrupt = 22;
constexpr uint32_t kEvFaultTruncate = 23;
constexpr uint32_t kEvFaultDelay = 24;
constexpr uint32_t kEvFaultStall = 25;
constexpr uint32_t kEvFaultSever = 26;
// 32 (precision_shift) is emitted by stengine.cpp; 33 marks one stripe of
// a striped link dying (arg = stripe index) while the link degrades to
// the survivors.
constexpr uint32_t kEvStripeDown = 33;
// r14 same-host shared-memory lane: 34 fires once when a link's data plane
// switches onto its shm rings (arg = ring bytes per direction); 35 when a
// negotiated attach fails validation and the link stays on TCP (arg = an
// errno-ish reason code — 1 open, 2 map, 3 header/token mismatch).
constexpr uint32_t kEvShmLaneUp = 34;
constexpr uint32_t kEvShmFallback = 35;
// 30 (trace_apply) and 31 (sub_attach, r10 subscriber link mode) are
// emitted by stengine.cpp; listed in obs/events.py CODE_NAMES like the
// rest — the numeric values are ABI across all three surfaces.
constexpr uint32_t kEvSubAttach = 31;
static_assert(kEvSubAttach == 31, "ABI code mirrored in obs/events.py");

}  // namespace stobs

extern "C" __attribute__((visibility("default"))) uint64_t st_obs_now_ns() {
  return stobs::now_ns();
}

extern "C" __attribute__((visibility("default"))) void st_obs_set_enabled(
    int32_t on) {
  stobs::g_enabled.store(on ? 1 : 0, std::memory_order_relaxed);
}

extern "C" __attribute__((visibility("default"))) uint64_t st_obs_dropped() {
  return stobs::g_dropped.load(std::memory_order_relaxed);
}

// Emission gate as an ABI call: the engine's r09 trace bookkeeping (clock
// reads, per-message hops/staleness accounting) keys off the same flag as
// ring emission, so the obs-overhead bench's paired A/B toggle
// (st_obs_set_enabled) covers the trace-stamping cost too.
extern "C" __attribute__((visibility("default"))) int32_t
st_obs_is_enabled() {
  return stobs::g_enabled.load(std::memory_order_relaxed);
}

// Record one event on the calling thread's ring. Cheap enough to leave on
// in production (one relaxed load when disabled; one clock read + one
// 32-byte store when armed) — and RARE by design: every call site is a
// protocol/recovery/fault event, never a per-element loop (the r09
// trace_apply events are per accepted wire MESSAGE, still orders of
// magnitude below per-element). ``extra`` lands in the record's fourth
// word (obs/events.py Event.extra) — r09 packs (origin_id << 8 | hops)
// there so one record carries a full trace-hop observation.
extern "C" __attribute__((visibility("default"))) void st_obs_emit2(
    uint32_t node_id, uint32_t code, int32_t link, uint64_t arg,
    uint32_t extra) {
  if (!stobs::g_enabled.load(std::memory_order_relaxed)) return;
  thread_local stobs::RingHolder tl;
  stobs::Ring* r = tl.r;
  uint64_t h = r->head.load(std::memory_order_relaxed);
  if (h - r->tail.load(std::memory_order_acquire) >= stobs::kEvRingCap) {
    stobs::g_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  stobs::EventRec& e = r->ev[h % stobs::kEvRingCap];
  e.t_ns = stobs::now_ns();
  e.node_id = node_id;
  e.code = code;
  e.link = link;
  e.reserved = extra;
  e.arg = arg;
  r->head.store(h + 1, std::memory_order_release);
}

extern "C" __attribute__((visibility("default"))) void st_obs_emit(
    uint32_t node_id, uint32_t code, int32_t link, uint64_t arg) {
  st_obs_emit2(node_id, code, link, arg, 0);
}

// Drain every thread's ring into buf (whole 32-byte records only); returns
// bytes written. Leftovers stay ring-buffered for the next drain. The
// registration mutex serializes concurrent drainers (Python side calls
// this from peers' recv loops); writers never touch it.
extern "C" __attribute__((visibility("default"))) int32_t st_obs_drain(
    uint8_t* buf, int32_t cap_bytes) {
  int32_t written = 0;
  StLockGuard lk(stobs::g_reg_mu);
  for (stobs::Ring* r : stobs::g_rings) {
    uint64_t t = r->tail.load(std::memory_order_relaxed);
    uint64_t h = r->head.load(std::memory_order_acquire);
    while (t < h &&
           cap_bytes - written >= (int32_t)sizeof(stobs::EventRec)) {
      std::memcpy(buf + written, &r->ev[t % stobs::kEvRingCap],
                  sizeof(stobs::EventRec));
      written += (int32_t)sizeof(stobs::EventRec);
      t++;
    }
    r->tail.store(t, std::memory_order_release);
  }
  return written;
}

// ---- r14 same-host shared-memory lane ------------------------------------
//
// When both endpoints of a link live on one host (negotiated at the Python
// tier's SYNC/WELCOME hello — compat.SYNC_FLAG_SHM + boot-id match, the
// same tolerant-extension discipline as every capability since r09), the
// link's DATA plane moves into a mapped /dev/shm segment: one SPSC byte
// ring per direction, records framed [u32 len][u64 stripe_seq][payload],
// futex wake with spin-before-sleep. The TCP connection STAYS UP as the
// control/teardown/liveness channel — keepalives, join/seq semantics,
// SNAP/RESUME, quarantine/carry/re-graft are all untouched; the lane
// slots in below the wire-seq layer exactly as r11 striping did.
//
// Ordering across the lane switch:
//  - striped links: every record carries the message's stripe seq, so the
//    ring feeds the SAME reassembly window as the sockets
//    (deliver_striped) — in-flight TCP messages and ring records
//    interleave correctly with no barrier at all;
//  - unstriped links: the single sender writes one SWITCH marker
//    ([u32 kShmSwitchLen], a length no real frame can have) as its LAST
//    data-plane byte on TCP, then moves to the ring; the receiver enables
//    ring delivery only when the marker arrives in-stream, so the
//    TCP-before / ring-after order is exact. The marker is only ever sent
//    after a successful shm attach, i.e. never to a pre-r14 peer.
//
// Messages LARGER than the ring stream through it: the writer publishes
// the record header, then payload chunks as space frees; the reader
// drains chunks into its rx buffer as they appear. The ring therefore
// bounds memory, not message size ("slots sized for max traced sign2
// bursts" degrades gracefully when a burst outgrows the default).
//
// Teardown: either side stores hdr->closed and futex-wakes all wait
// words (kill_link does this); a peer death is detected by the TCP
// control channel exactly as before and tears the lane down with the
// link.
//
// Liveness: the TCP socket of a lane link carries no data, so its reader's
// SO_RCVTIMEO (peer_timeout_sec) would fire on a link whose messages all
// ride the ring. The lane's writer therefore writes a keepalive on the
// socket whenever keepalive_sec has passed since its last TCP write,
// however busy the ring is (the sender loop's idle keepalive alone never
// fires while its queue receives a message more often than once a
// keepalive_sec, which the Python tier's digests do), and a reader whose
// socket timed out with no byte of a message read re-arms when ring
// records arrived since its last timeout (a peer whose writer keeps the
// idle-only rule stays alive while its ring delivers). The segment file is unlinked by the JOINER the moment it maps
// (leak-proof: after that the name cannot outlive the two mappings); the
// creator unlinks at teardown if the joiner never arrived.
namespace stshm {

constexpr uint64_t kMagic = 0x535453484D313400ull;  // "STSHM14\0"
constexpr uint32_t kVersion = 1;
constexpr uint32_t kRecHdr = 12;  // u32 len + u64 sseq
// SWITCH marker length value (unstriped links): above kMaxPayload, so it
// can never collide with a real frame length.
constexpr uint32_t kShmSwitchLen = 0xFFFFFFFDu;
constexpr int kSpins = 2000;  // spin-before-sleep iterations

inline int futex_wait(std::atomic<uint32_t>* w, uint32_t val,
                      long timeout_ms) {
  timespec ts;
  ts.tv_sec = timeout_ms / 1000;
  ts.tv_nsec = (timeout_ms % 1000) * 1000000L;
  // non-PRIVATE futex: the word lives in a shared mapping, the waiter and
  // waker are different processes
  return (int)syscall(SYS_futex, (uint32_t*)w, FUTEX_WAIT, val, &ts,
                      nullptr, 0);
}

inline void futex_wake_all(std::atomic<uint32_t>* w) {
  syscall(SYS_futex, (uint32_t*)w, FUTEX_WAKE, INT32_MAX, nullptr, nullptr,
          0);
}

// One direction's control block. head/tail are BYTE positions (monotonic
// u64; offset = pos % ring_bytes). head_seq/tail_seq are the futex words
// (bumped on every publish/consume). *_waiting gates the wake syscall so
// the uncontended fast path never enters the kernel.
struct alignas(64) RingCtl {
  std::atomic<uint64_t> head;
  std::atomic<uint32_t> head_seq;
  std::atomic<uint32_t> rd_waiting;
  char pad0[64 - 16];
  std::atomic<uint64_t> tail;
  std::atomic<uint32_t> tail_seq;
  std::atomic<uint32_t> wr_waiting;
  char pad1[64 - 16];
};
static_assert(sizeof(RingCtl) == 128, "two cachelines, no false sharing");

// Segment header (one page); ring data follows at kDataOff and
// kDataOff + ring_bytes. ring[0] carries creator->joiner, ring[1]
// joiner->creator.
struct Hdr {
  uint64_t magic;
  uint32_t version;
  uint32_t ring_bytes;
  uint64_t token;
  std::atomic<uint32_t> joined;  // joiner stores 1 after validating
  std::atomic<uint32_t> closed;  // either side stores 1 at teardown
  char pad[128 - 32];
  RingCtl ring[2];
};
constexpr size_t kDataOff = 4096;
static_assert(sizeof(Hdr) <= kDataOff, "header fits the first page");
static_assert(std::atomic<uint64_t>::is_always_lock_free &&
                  std::atomic<uint32_t>::is_always_lock_free,
              "cross-process atomics must be lock-free");

// One mapped lane attached to a Link. tx/rx pick the direction by role.
struct Lane {
  Hdr* hdr = nullptr;
  uint8_t* data[2] = {nullptr, nullptr};
  size_t map_len = 0;
  uint32_t ring_bytes = 0;
  int creator = 0;  // 1 = we created (tx on ring[0]), 0 = joined (ring[1])
  std::string name;  // /dev/shm basename (creator keeps it for unlink)
  std::atomic<bool> marker_sent{false};  // unstriped: SWITCH written (tx)
  std::atomic<bool> rx_go{false};  // delivery enabled (striped: at map)
  std::atomic<bool> ev_emitted{false};
  // The ring is SPSC; the single writer is normally the lowest live
  // stripe's sender thread. During a stripe death the writer role
  // PROMOTES to the next live stripe, and the old and new writer can
  // briefly overlap — tx_mu serializes whole records across that window
  // (uncontended in steady state; record order across writers is
  // reassembled by stripe seq exactly like socket stripes). Guards the
  // tx ring's head position and record integrity; a leaf in the lock
  // hierarchy (nothing is acquired under it).
  StMutex tx_mu;
  // lane counters (st_node_shm_stats; bytes/frames also fold into the
  // link's existing wire counters so the taxonomy holds across lanes)
  std::atomic<uint64_t> msgs_out{0}, msgs_in{0};
  std::atomic<uint64_t> bytes_out{0}, bytes_in{0};
  std::atomic<uint64_t> tx_waits{0}, rx_waits{0};

  RingCtl& tx_ctl() { return hdr->ring[creator ? 0 : 1]; }
  RingCtl& rx_ctl() { return hdr->ring[creator ? 1 : 0]; }
  uint8_t* tx_data() { return data[creator ? 0 : 1]; }
  uint8_t* rx_data() { return data[creator ? 1 : 0]; }

  // tx is live once both sides are mapped (the joiner publishes
  // hdr->joined; for the joiner itself that is immediate)
  bool tx_ready() {
    return hdr && hdr->closed.load(std::memory_order_relaxed) == 0 &&
           hdr->joined.load(std::memory_order_acquire) != 0;
  }

  void close_and_wake() {
    if (!hdr) return;
    hdr->closed.store(1, std::memory_order_release);
    for (int i = 0; i < 2; i++) {
      futex_wake_all(&hdr->ring[i].head_seq);
      futex_wake_all(&hdr->ring[i].tail_seq);
    }
  }

  ~Lane() {
    if (hdr) {
      if (creator && hdr->joined.load(std::memory_order_relaxed) == 0 &&
          !name.empty()) {
        // joiner never arrived: reclaim the name (the joiner unlinks on a
        // successful map — see st_node_shm_join)
        std::string p = "/dev/shm/" + name;
        ::unlink(p.c_str());
      }
      ::munmap((void*)hdr, map_len);
    }
  }
};

// Non-temporal bulk copy INTO the ring: the destination is only ever
// read by the PEER process (another core, through L3/DRAM), so regular
// stores waste a full read-for-ownership stream on bytes we will never
// look at — at 4 MiB messages that is a third of the copy's memory
// traffic. Weakly-ordered NT stores REQUIRE an sfence before the head
// publish (shm_write_record does it); the scalar head/tail protocol is
// untouched.
inline void nt_copy(uint8_t* dst, const uint8_t* src, size_t n) {
#if defined(__x86_64__) && defined(__SSE2__) && !defined(ST_ANALYZE_NO_SIMD)
  if (n >= 256) {
    // align dst to 16 for the streaming stores
    size_t head = ((uintptr_t)dst & 15) ? 16 - ((uintptr_t)dst & 15) : 0;
    if (head) {
      std::memcpy(dst, src, head);
      dst += head;
      src += head;
      n -= head;
    }
    while (n >= 64) {
      __m128i a, b, c, d;
      std::memcpy(&a, src, 16);
      std::memcpy(&b, src + 16, 16);
      std::memcpy(&c, src + 32, 16);
      std::memcpy(&d, src + 48, 16);
      _mm_stream_si128((__m128i*)dst, a);
      _mm_stream_si128((__m128i*)(dst + 16), b);
      _mm_stream_si128((__m128i*)(dst + 32), c);
      _mm_stream_si128((__m128i*)(dst + 48), d);
      dst += 64;
      src += 64;
      n -= 64;
    }
  }
#endif
  std::memcpy(dst, src, n);
}

// wrap-aware copies between a ring's data area and a flat buffer
inline void ring_put(uint8_t* base, uint32_t rb, uint64_t pos,
                     const uint8_t* src, size_t n) {
  size_t off = (size_t)(pos % rb);
  size_t first = std::min(n, (size_t)rb - off);
  nt_copy(base + off, src, first);
  if (n > first) nt_copy(base, src + first, n - first);
}

inline void ring_get(const uint8_t* base, uint32_t rb, uint64_t pos,
                     uint8_t* dst, size_t n) {
  size_t off = (size_t)(pos % rb);
  size_t first = std::min(n, (size_t)rb - off);
  std::memcpy(dst, base + off, first);
  if (n > first) std::memcpy(dst + first, base, n - first);
}

}  // namespace stshm

namespace {

using Clock = std::chrono::steady_clock;

constexpr uint32_t kMaxPayload = 1u << 30;  // 1 GiB sanity cap
// 'STT3' since r06: DATA/BURST payloads gained a u32 tx_seq after the kind
// byte (go-back-N, comm/wire.py). The framing change is handshake-breaking
// by design — a pre-seq peer pairing with a post-seq peer would silently
// mis-ack (old rule: undecodable still counts) or discard-and-churn; the
// magic bump turns both into an explicit join rejection.
constexpr char kMagic[4] = {'S', 'T', 'T', '3'};
// r11 multi-socket link striping. A joiner that wants a striped link
// sends the 'STT4' hello ([magic][u32 hint][u32 want_stripes]); the
// acceptor replies 'Y' + [u8 granted][u64 token] and the joiner opens
// granted-1 extra connections, each announcing itself with the 'STTS'
// stripe hello ([magic][u64 token][u8 stripe_idx], ack 'y'). Per-stripe
// framing gains an 8-byte stripe sequence after the length prefix
// ([u32 len][u64 sseq][payload]; len == 0 keepalives stay 4 bytes), from
// which the receiver reassembles the link's single in-order stream —
// round-robin striping with per-message tags, so any stripe may carry any
// message and a dead stripe's in-flight messages re-route to survivors.
// stripe_count == 1 keeps the STT3 hello and the r10 framing byte-for-
// byte (the compat escape hatch for joining pre-r11 trees); an STT4 hello
// at a pre-r11 acceptor fails the magic check and is rejected, the same
// explicit-breakage discipline as the STT3 bump itself.
constexpr char kMagic4[4] = {'S', 'T', 'T', '4'};
constexpr char kMagicS[4] = {'S', 'T', 'T', 'S'};
constexpr int kMaxStripes = 8;
// Reorder window: how far (in messages) one stripe may run ahead of the
// link's in-order delivery point before its reader blocks — the
// backpressure that bounds reassembly memory (a dead stripe holding the
// window closed is eventually killed by its liveness timeout).
constexpr uint64_t kReorderWindow = 4096;
// Messages coalesced into ONE kernel crossing on the clean send path
// (faults and pacing off): r11 gathered up to 8 into a single writev;
// r14 widens the batch and submits it as one sendmmsg — each queued
// message keeps its own mmsghdr (header + payload iovecs, borrowed ring
// slots included, no copies), so partial completion is handled
// per-message instead of by re-walking one flat iovec window.
constexpr int kCoalesce = 16;

// ---- fault injection (env-gated hook table; comm/faults.py to_env) -------
//
// ST_FAULT_PLAN="seed=N,drop=P,dup=P,trunc=P,corrupt=P,delay_pct=P,
// delay_ms=M,stall_after=K,sever_after=K,only_link=L" installs deterministic
// wire faults on every node CREATED while the variable is set (parsed per
// st_node_create, so a test can make exactly one node chaotic). Faults
// apply only to DATA frames on the sender side — native framing kind 0/7,
// or any non-keepalive payload in wire-compat mode — never to handshake or
// ACK traffic, so injected chaos drives the recovery machinery (ledger
// rollback, carry, re-graft) instead of wedging a join. This is the native
// twin of the Python tier's FaultPlan (comm/faults.py): both tiers face
// the same fault classes from the same config.
//
// ST_FAULT_CRASH="point:N" additionally arms a process-wide kill at a
// named protocol point (here: "mid-join-walk"); see also stengine.cpp's
// points. The process dies with _exit(17) — no destructors, no drain:
// the whole point is that nothing below the point runs.
struct FaultPlan {
  int enabled = 0;
  uint64_t seed = 0;
  double drop = 0, dup = 0, trunc = 0, corrupt = 0, delay_pct = 0;
  double delay_ms = 0;
  int64_t stall_after = -1;  // >=0: swallow data frames past the Nth, per link
  int64_t sever_after = 0;   // >0: hard-kill the link at its Nth data frame
  int32_t only_link = 0;     // >0: restrict ALL faults to this one link id
  // >=0: restrict ALL faults to this stripe index of each (striped) link —
  // the per-stripe chaos arm. sever_after then kills just that stripe
  // (the link degrades to the survivors) instead of the whole link.
  int32_t only_stripe = -1;
};

FaultPlan parse_fault_plan() {
  FaultPlan p;
  const char* env = getenv("ST_FAULT_PLAN");
  if (!env || !*env) return p;
  p.enabled = 1;
  std::string s(env);
  size_t i = 0;
  while (i <= s.size()) {
    size_t j = s.find(',', i);
    if (j == std::string::npos) j = s.size();
    std::string kv = s.substr(i, j - i);
    size_t eq = kv.find('=');
    if (eq != std::string::npos) {
      std::string k = kv.substr(0, eq);
      double v = atof(kv.c_str() + eq + 1);
      if (k == "seed") p.seed = (uint64_t)v;
      else if (k == "drop") p.drop = v;
      else if (k == "dup") p.dup = v;
      else if (k == "trunc") p.trunc = v;
      else if (k == "corrupt") p.corrupt = v;
      else if (k == "delay_pct") p.delay_pct = v;
      else if (k == "delay_ms") p.delay_ms = v;
      else if (k == "stall_after") p.stall_after = (int64_t)v;
      else if (k == "sever_after") p.sever_after = (int64_t)v;
      else if (k == "only_link") p.only_link = (int32_t)v;
      else if (k == "only_stripe") p.only_stripe = (int32_t)v;
    }
    i = j + 1;
  }
  return p;
}

// xorshift64: deterministic per-link stream (seeded seed ^ f(link id)),
// uniform in [0, 1). Never zero-state (the splat constant guards it).
inline double frand64(uint64_t* st) {
  uint64_t x = *st ? *st : 0x9e3779b97f4a7c15ull;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  *st = x;
  return (double)(x >> 11) / (double)(1ull << 53);
}

struct Config {
  int32_t wire_compat = 0;
  // compat mode: fixed frame payload size (4 + ceil(n/8)); native: 0.
  int32_t compat_frame_bytes = 0;
  int32_t listen_backlog = 128;
  int64_t bandwidth_cap_bps = 0;   // outgoing payload bytes/sec per link
  double peer_timeout_sec = 30.0;  // 0 = no liveness timeout
  double keepalive_sec = 1.0;
  int32_t max_children = 2;
  int32_t queue_depth = 8;
  int32_t max_rejoin_attempts = 8;
  double rejoin_backoff_sec = 0.2;
  // Bounded joins (TransportConfig twins): per-attempt connect()/reply
  // bound and the total create-time join budget. 0 = legacy behavior
  // (blocking connect / fixed attempt count).
  double connect_timeout_sec = 5.0;
  double join_timeout_sec = 30.0;
  int32_t stripe_count = 1;  // sockets per logical link (r11; 1..8)
  // SO_RCVBUF of every socket this node connects (its uplink's stripes),
  // set before connect() so that the window scale it negotiates follows
  // it; 0 keeps the kernel's autotuned size. A read-only subscriber sets
  // a few frames here: the bytes its writer can have in flight to it.
  int32_t rcvbuf_bytes = 0;
  FaultPlan fault;  // env-gated wire chaos (parse_fault_plan)
};

struct Event {
  int32_t kind;  // 1 = link up, 2 = link down, 3 = became master
  int32_t link_id;
  int32_t is_uplink;
};

// One outgoing wire message (r07 ring-buffer data plane). Two ownership
// modes:
//  - OWNED: `owned` holds a private copy (the legacy st_node_send path —
//    the bytes cross the ctypes boundary once, into a pooled vector);
//  - BORROWED (zero-copy): `zdata/zlen` point into the CALLER's buffer
//    (the native engine's tx ring slot); the transport guarantees it calls
//    `release(ctx)` exactly once when it is done with the bytes — after
//    the socket write, or at teardown if the link dies with the message
//    still queued. Destruction IS the release (RAII), so no teardown path
//    can leak a ring slot.
// A borrowed message's bytes double as the sender's retransmission ledger
// entry, so the transport must never MUTATE them: the fault injector
// copies-on-write before corrupting (see link_sender_loop).
struct OutMsg {
  std::vector<uint8_t> owned;
  const uint8_t* zdata = nullptr;
  uint32_t zlen = 0;
  void (*release)(void*) = nullptr;
  void* ctx = nullptr;
  // Stripe sequence (r11): stamped at enqueue (push_hook under the queue
  // mutex), written on the wire after the length prefix of striped links,
  // and the receiver's reassembly key. A re-enqueued message (its stripe
  // died at write time) keeps its stamp — the receiver's window dedups if
  // the dead socket had actually delivered it.
  uint64_t sseq = 0;

  OutMsg() = default;
  OutMsg(const OutMsg&) = delete;
  OutMsg& operator=(const OutMsg&) = delete;
  OutMsg(OutMsg&& o) noexcept { *this = std::move(o); }
  OutMsg& operator=(OutMsg&& o) noexcept {
    if (this != &o) {
      reset();
      owned = std::move(o.owned);
      zdata = o.zdata;
      zlen = o.zlen;
      release = o.release;
      ctx = o.ctx;
      sseq = o.sseq;
      o.zdata = nullptr;
      o.zlen = 0;
      o.release = nullptr;
      o.ctx = nullptr;
    }
    return *this;
  }
  void reset() {
    if (release) {
      release(ctx);
      release = nullptr;
    }
    zdata = nullptr;
    zlen = 0;
  }
  ~OutMsg() { reset(); }
  const uint8_t* data() const { return zdata ? zdata : owned.data(); }
  size_t size() const { return zdata ? zlen : owned.size(); }
};

// Bounded MPMC queue with close() wakeup; carries received byte buffers
// (recvq) or OutMsg send descriptors (sendq).
template <typename T>
class FrameQueue {
 public:
  explicit FrameQueue(size_t cap) : cap_(cap) {}

  bool push(T&& f, double timeout_sec) {
    return push_hook(std::move(f), timeout_sec, [](T&) {});
  }

  // push with a stamp hook run under the queue mutex at insertion — the
  // r11 stripe-seq stamp site (a failed/timed-out push runs no hook, so
  // a stamped sequence is always eventually written).
  // Explicit deadline loops (not wait_for-with-predicate) throughout this
  // class: a predicate lambda reads the mu_-guarded queue state from a
  // context the thread-safety analysis treats as lock-free.
  template <typename F>
  bool push_hook(T&& f, double timeout_sec, F&& hook) {
    StUniqueLock lk(mu_);
    const auto deadline = st_cv_deadline(timeout_sec);
    while (!closed_ && q_.size() >= cap_) {
      if (not_full_.wait_until(lk.native(), deadline) ==
          std::cv_status::timeout)
        break;
    }
    if (closed_ || q_.size() >= cap_) return false;
    hook(f);
    q_.push_back(std::move(f));
    not_empty_.notify_one();
    return true;
  }

  bool pop(T* out, double timeout_sec) {
    StUniqueLock lk(mu_);
    const auto deadline = st_cv_deadline(timeout_sec);
    while (!closed_ && q_.empty()) {
      if (not_empty_.wait_until(lk.native(), deadline) ==
          std::cv_status::timeout)
        break;
    }
    if (q_.empty()) return false;  // timed out, or closed and drained
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  size_t size() {
    StLockGuard lk(mu_);
    return q_.size();
  }

  void close() {
    StLockGuard lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  StMutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<T> q_ ST_GUARDED_BY(mu_);
  size_t cap_;
  bool closed_ ST_GUARDED_BY(mu_) = false;
};

// Small free-list of byte buffers (capacity-preserving): the per-message
// heap allocation the r07 data plane removes. Bounded so an idle link's
// high-water mark doesn't pin memory forever.
class BufPool {
 public:
  explicit BufPool(size_t keep) : keep_(keep) {}

  // a recycled buffer (capacity warm) or a fresh one; `hit` reports which
  std::vector<uint8_t> get(bool* hit) {
    StLockGuard lk(mu_);
    if (!free_.empty()) {
      std::vector<uint8_t> b = std::move(free_.back());
      free_.pop_back();
      *hit = true;
      return b;
    }
    *hit = false;
    return {};
  }

  void put(std::vector<uint8_t>&& b) {
    StLockGuard lk(mu_);
    if (free_.size() < keep_) free_.push_back(std::move(b));
    // else: drop — the deallocation is the bound, not a leak
  }

 private:
  StMutex mu_;
  std::vector<std::vector<uint8_t>> free_ ST_GUARDED_BY(mu_);
  size_t keep_;
};

// One full-duplex framed TCP link (the reference's synca/sync_in thread pair,
// src/sharedtensor.c:113-189, minus the codec math which lives on-device).
struct Link {
  int32_t id = -1;
  int fd = -1;  // stripe 0's fd (kept for the pre-stripe call sites)
  int32_t is_uplink = 0;
  std::atomic<bool> alive{true};
  // r11 striping: up to kMaxStripes sockets carry this ONE logical link.
  // stripe_fd[0] == fd; each ATTACHED stripe runs its own sender+receiver
  // thread pair (the last of a stripe's two threads closes that stripe's
  // fd — same fd-reuse rationale as the old io_refs). A stripe dies alone
  // (kill_stripe: messages re-route, receiver reassembly skips nothing
  // because sseq tags survive); the LAST live stripe's death is the
  // link's.
  int nstripes = 1;
  // Atomic: the acceptor's attach_stripe (listener thread, replayed-STTS
  // guard included) stores a stripe's fd while kill_link/kill_stripe and
  // the sibling I/O threads read the array — a plain int here was a
  // narrow but real data race (the fd VALUE is still stable from each
  // reader's perspective: it is written once per attached stripe, and the
  // idx-reuse guard rejects re-attachment).
  std::atomic<int> stripe_fd[kMaxStripes];
  std::atomic<bool> stripe_ok[kMaxStripes] = {};
  std::atomic<int> stripe_io[kMaxStripes] = {};
  std::atomic<int> stripes_live{0};
  std::atomic<uint64_t> stripe_deaths{0}, reroutes{0};
  // tx stripe-seq allocator (stamped in push_hook / dup-injection)
  std::atomic<uint64_t> sseq_next{0};
  // most messages a sender thread takes from sendq for one socket write
  // (st_node_cap_inflight lowers it to 1 on a subscriber link)
  std::atomic<int> batch_max{kCoalesce};
  // rx reassembly (striped links only): out-of-order messages park in
  // `reorder` until `rnext` arrives; `delivering` elects one drainer; the
  // window condvar blocks readers that run too far ahead (backpressure).
  StMutex rmu;
  std::condition_variable rcv;
  std::map<uint64_t, std::vector<uint8_t>> reorder ST_GUARDED_BY(rmu);
  uint64_t rnext ST_GUARDED_BY(rmu) = 0;
  bool delivering ST_GUARDED_BY(rmu) = false;
  // stripe senders share the per-link fault-plan state below; the mutex
  // is taken ONLY when the plan is enabled (chaos builds)
  StMutex fault_mu;
  FrameQueue<OutMsg> sendq;
  FrameQueue<std::vector<uint8_t>> recvq;
  // r07 buffer recycling: tx buffers cycle enqueue -> socket write -> free
  // list; rx buffers cycle socket read -> recvq -> consumer copy-out
  // (st_node_recv) -> free list. Bounded at queue_depth + 2 each, so the
  // steady state allocates nothing per message without pinning an idle
  // link's high-water memory.
  BufPool tx_pool, rx_pool;
  // stats
  std::atomic<uint64_t> bytes_out{0}, bytes_in{0}, frames_out{0}, frames_in{0};
  // the peer address as observed by accept(); because children bind their
  // listen socket to their uplink's local endpoint (the reference's
  // addressing trick, src/sharedtensor.c:292-316), this doubles as the
  // child's listen address for redirects.
  sockaddr_in peer_addr{};
  // fault-injection state (only touched when the node's plan is enabled;
  // stripe senders share it under fault_mu)
  uint64_t fault_rng ST_GUARDED_BY(fault_mu) = 0;
  // data frames seen at this wire boundary
  int64_t fault_frames ST_GUARDED_BY(fault_mu) = 0;
  // r14 same-host shm lane (stshm::Lane), set ONCE under Node::mu by
  // st_node_shm_serve/join and read lock-free everywhere after (the
  // pointer never changes once non-null; the Lane's own fields are
  // atomics or written before publication). Freed by ~Link, which runs
  // only after every I/O thread dropped its shared_ptr.
  std::atomic<stshm::Lane*> shm{nullptr};

  Link(size_t qdepth)
      : sendq(qdepth),
        recvq(qdepth),
        tx_pool(qdepth + 2),
        rx_pool(qdepth + 2) {
    for (auto& f : stripe_fd) f.store(-1, std::memory_order_relaxed);
  }
  ~Link() { delete shm.load(std::memory_order_acquire); }
};

struct Node;
void link_sender_loop(Node* node, std::shared_ptr<Link> link, int sidx);
void link_receiver_loop(Node* node, std::shared_ptr<Link> link, int sidx);
void shm_rx_loop(Node* node, std::shared_ptr<Link> link);
bool deliver_striped(Node* node, const std::shared_ptr<Link>& link,
                     uint64_t sseq, std::vector<uint8_t>&& frame);
void listener_loop(Node* node, int listen_fd);
void rejoin_loop(Node* node);

struct Node {
  Config cfg;
  // process-unique obs id: tags this node's events on the shared per-thread
  // rings so a multi-peer process still yields per-node timelines
  uint32_t obs_id = 0;
  std::atomic<bool> closing{false};
  std::atomic<int> active_threads{0};  // all detached; close() drains to 0

  StMutex mu;  // guards membership: links, child slots, next id, role
  int listen_fd = -1;
  // A re-graft's uplink has a new local endpoint, which the new parent hands
  // out in redirects (the reference's addressing trick, as for the first
  // join's listen_fd). rejoin_loop listens there too: listen_fd stays, since
  // st_node_listen_port handed its address out for the node's lifetime, and
  // the previous re-graft's listener retires (listener_loop closes it); -1
  // until the first re-graft.
  int regraft_listen_fd ST_GUARDED_BY(mu) = -1;
  // Second listener bound to the rendezvous address after a master
  // failover (rejoin_loop); -1 until then.
  int rendezvous_listen_fd ST_GUARDED_BY(mu) = -1;
  std::map<int32_t, std::shared_ptr<Link>> links ST_GUARDED_BY(mu);
  // up to max_children (<=16)
  std::shared_ptr<Link> child_slot[16] ST_GUARDED_BY(mu);
  int lrcounter ST_GUARDED_BY(mu) = 0;
  int32_t next_link_id ST_GUARDED_BY(mu) = 1;
  int32_t uplink_id ST_GUARDED_BY(mu) = -1;
  // r11: accepted-but-not-yet-attached stripe grants (listener 'STT4'
  // accept -> the joiner's 'STTS' stripe hellos resolve here). Guarded by
  // mu; entries expire after connect_timeout-ish and are pruned lazily.
  struct PendingStripe {
    uint64_t token;
    std::shared_ptr<Link> link;
    Clock::time_point deadline;
  };
  std::vector<PendingStripe> pending_stripes ST_GUARDED_BY(mu);
  uint64_t token_rng ST_GUARDED_BY(mu) = 0;  // seeded at create

  StMutex ev_mu;
  std::deque<Event> events ST_GUARDED_BY(ev_mu);
  std::condition_variable ev_cv;

  // Data-arrival signal: bumped (and notified) whenever any link pushes a
  // received frame, so a consumer (the native engine's receiver) can BLOCK
  // for new input across all links instead of polling each queue — the
  // poll-interval latency floor the Python tier suffers from (50ms drain /
  // 2ms recv sleeps) has no reason to exist at this layer.
  StMutex data_mu;
  std::condition_variable data_cv;
  uint64_t data_seq ST_GUARDED_BY(data_mu) = 0;

  sockaddr_in rendezvous{};  // written once at create, before any thread
  bool is_master ST_GUARDED_BY(mu) = false;
  std::string last_error;  // create-time only (no thread yet)
  uint64_t jrng = 0;  // rejoin-backoff jitter stream (rejoin_loop only;
                      // create seeds it before the thread starts)

  // r07 pool observability (st_node_pool_stats): steady state must show
  // acquires growing while misses (fresh allocations) stay flat — the
  // zero-per-message-allocation assertion the tests/metrics make.
  std::atomic<uint64_t> tx_acquires{0}, tx_pool_misses{0};
  std::atomic<uint64_t> rx_acquires{0}, rx_pool_misses{0};
  std::atomic<uint64_t> zc_msgs{0};  // zero-copy (borrowed) sends enqueued

  // r14 zero-copy receive loans (st_node_recv_zc): the popped rx buffer
  // parks here, keyed by link id, until the NEXT recv_zc/recv_done on the
  // same link releases it — so the borrowed pointer stays valid even if
  // the Link itself is torn down mid-parse. Loans live on the NODE (not
  // the Link) precisely for that teardown window. loan_mu is a leaf
  // (nothing acquired under it); it is taken sequentially with mu, never
  // nested.
  StMutex loan_mu;
  std::map<int32_t, std::vector<uint8_t>> loans ST_GUARDED_BY(loan_mu);

  void notify_data() ST_EXCLUDES(data_mu) {
    {
      StLockGuard lk(data_mu);
      data_seq++;
    }
    data_cv.notify_all();
  }

  void emit(int32_t kind, int32_t link_id, int32_t is_uplink)
      ST_EXCLUDES(ev_mu) {
    // membership events double as timeline events (codes 1..4 == kinds)
    st_obs_emit(obs_id, (uint32_t)kind, link_id, (uint64_t)is_uplink);
    StLockGuard lk(ev_mu);
    events.push_back({kind, link_id, is_uplink});
    ev_cv.notify_all();
  }
};

// ---- robust I/O (the reference's read_or_die/write_or_die, but returning
// errors instead of exiting the process) --------------------------------

bool read_full(int fd, uint8_t* buf, size_t count) {
  while (count) {
    ssize_t r = ::read(fd, buf, count);
    if (r == 0) return false;  // peer closed
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;  // includes EAGAIN from SO_RCVTIMEO => liveness timeout
    }
    buf += r;
    count -= r;
  }
  return true;
}

// read_full for a message's 4-byte length prefix on a link whose data may
// ride the shm lane (the lane's Liveness note): a liveness timeout with no
// byte read re-arms while the lane delivered ring records since the last
// one (*ring_seen, that count). A link without a lane, a timeout past its
// first byte, and a peer that closed fail as in read_full.
bool read_prefix(int fd, uint8_t* hdr, std::atomic<stshm::Lane*>& shm,
                 uint64_t* ring_seen) {
  size_t got = 0;
  while (got < 4) {
    ssize_t r = ::read(fd, hdr + got, 4 - got);
    if (r == 0) return false;  // peer closed
    if (r < 0) {
      if (errno == EINTR) continue;
      stshm::Lane* sl = shm.load(std::memory_order_acquire);
      if (got == 0 && (errno == EAGAIN || errno == EWOULDBLOCK) && sl) {
        uint64_t n = sl->msgs_in.load(std::memory_order_relaxed);
        if (n != *ring_seen) {
          *ring_seen = n;
          continue;
        }
      }
      return false;
    }
    got += (size_t)r;
  }
  return true;
}

bool write_full(int fd, const uint8_t* buf, size_t count) {
  while (count) {
    ssize_t r = ::write(fd, buf, count);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += r;
    count -= r;
  }
  return true;
}

// Scatter-gather write: length-prefix + payload leave in ONE syscall
// (writev) instead of the old two write()s per message — and the payload
// iovec can point straight into a borrowed ring slot (no contiguous
// hdr+payload buffer ever exists). Handles short writes by advancing the
// iovec window.
bool writev_full(int fd, struct iovec* iov, int iovcnt) {
  while (iovcnt > 0 && iov->iov_len == 0) {
    iov++;
    iovcnt--;
  }
  while (iovcnt > 0) {
    ssize_t r = ::writev(fd, iov, iovcnt);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t n = (size_t)r;
    while (iovcnt > 0 && n >= iov->iov_len) {
      n -= iov->iov_len;
      iov++;
      iovcnt--;
    }
    if (iovcnt > 0) {
      iov->iov_base = (uint8_t*)iov->iov_base + n;
      iov->iov_len -= n;
    }
  }
  return true;
}

inline bool listen_fd_ok(int fd) { return fd >= 0; }

void set_common_sockopts(int fd) {
  int yes = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &yes, sizeof yes);
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &yes, sizeof yes);
}

void set_rcvbuf(int fd, int32_t bytes) {
  if (bytes > 0) setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bytes, sizeof bytes);
}

void set_recv_timeout(int fd, double sec) {
  if (sec <= 0) return;
  timeval tv;
  tv.tv_sec = (time_t)sec;
  tv.tv_usec = (suseconds_t)((sec - (double)tv.tv_sec) * 1e6);
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
}

// Bounded connect: nonblocking connect + poll, restoring blocking mode on
// the way out. The reference's blocking connect() hangs FOREVER against a
// rendezvous that drops packets (no RST) — the join walk needs a per-hop
// bound so a dead target fails in bounded time instead. timeout <= 0
// keeps the legacy blocking behavior.
bool connect_with_timeout(int fd, const sockaddr_in* addr,
                          double timeout_sec) {
  if (timeout_sec <= 0)
    return ::connect(fd, (const sockaddr*)addr, sizeof *addr) == 0;
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int r = ::connect(fd, (const sockaddr*)addr, sizeof *addr);
  bool ok = r == 0;
  if (!ok && errno == EINPROGRESS) {
    pollfd pfd{};
    pfd.fd = fd;
    pfd.events = POLLOUT;
    if (::poll(&pfd, 1, (int)(timeout_sec * 1000.0)) == 1) {
      int err = 0;
      socklen_t len = sizeof err;
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
      ok = err == 0;
    }
  }
  fcntl(fd, F_SETFL, flags);
  return ok;
}

// ---- link lifecycle ------------------------------------------------------

// Spawn the I/O thread pair for one ATTACHED stripe (stripe 0 at
// make_link; extra stripes as their sockets arrive — joiner's
// open_stripes / acceptor's 'STTS' hello).
void attach_stripe(Node* node, const std::shared_ptr<Link>& link, int sidx,
                   int fd) {
  link->stripe_fd[sidx] = fd;
  link->stripe_io[sidx].store(2);
  link->stripe_ok[sidx].store(true);
  link->stripes_live++;
  set_recv_timeout(fd, node->cfg.peer_timeout_sec);
  node->active_threads += 2;
  std::thread(link_sender_loop, node, link, sidx).detach();
  std::thread(link_receiver_loop, node, link, sidx).detach();
}

std::shared_ptr<Link> make_link(Node* node, int fd, int32_t is_uplink,
                                const sockaddr_in* peer, int nstripes = 1) {
  auto link = std::make_shared<Link>((size_t)node->cfg.queue_depth);
  if (nstripes < 1) nstripes = 1;
  if (nstripes > kMaxStripes) nstripes = kMaxStripes;
  {
    StLockGuard lk(node->mu);
    link->id = node->next_link_id++;
    link->fd = fd;
    link->nstripes = nstripes;
    link->is_uplink = is_uplink;
    if (peer) link->peer_addr = *peer;
    node->links[link->id] = link;
    if (is_uplink) node->uplink_id = link->id;
  }
  attach_stripe(node, link, 0, fd);
  node->emit(1, link->id, is_uplink);
  return link;
}

// Tear down one link (all stripes); the rest of the node keeps running
// (the fix for the reference's exit(-1)-on-any-error model,
// src/sharedtensor.c:61-63).
void kill_link(Node* node, std::shared_ptr<Link> link) {
  bool was_alive = link->alive.exchange(false);
  if (!was_alive) return;
  for (int i = 0; i < link->nstripes; i++)
    if (link->stripe_fd[i] >= 0) ::shutdown(link->stripe_fd[i], SHUT_RDWR);
  // shm lane down with the link: mark the segment closed and futex-wake
  // both rings so a blocked peer writer/reader (and our own shm threads)
  // observe the death instead of sleeping out their timeout slices
  if (stshm::Lane* sl = link->shm.load(std::memory_order_acquire))
    sl->close_and_wake();
  link->sendq.close();
  link->recvq.close();
  {
    StLockGuard lk(link->rmu);
  }
  link->rcv.notify_all();  // unblock window-waiting stripe readers
  bool was_uplink = false;
  {
    StLockGuard lk(node->mu);
    for (int i = 0; i < node->cfg.max_children; i++)
      if (node->child_slot[i] == link) node->child_slot[i] = nullptr;
    if (node->uplink_id == link->id) {
      node->uplink_id = -1;
      was_uplink = true;
    }
    node->links.erase(link->id);
  }
  node->emit(2, link->id, was_uplink ? 1 : 0);
  // fds are closed by each stripe's last I/O thread (stripe_io_exit);
  // shutdown() above already unblocked them all.
}

// Tear down ONE stripe; the link degrades to the survivors (in-flight
// messages re-route by stripe-seq), and the LAST stripe's death is the
// link's.
void kill_stripe(Node* node, std::shared_ptr<Link> link, int sidx) {
  bool was = link->stripe_ok[sidx].exchange(false);
  if (!was) return;
  ::shutdown(link->stripe_fd[sidx], SHUT_RDWR);
  link->rcv.notify_all();
  if (--link->stripes_live <= 0) {
    // the LAST stripe's death is the link's (link_down event), and an
    // unstriped link's only teardown path runs through here too —
    // neither is a degradation, so neither counts a stripe death
    kill_link(node, link);
    return;
  }
  link->stripe_deaths++;
  st_obs_emit(node->obs_id, stobs::kEvStripeDown, link->id, (uint64_t)sidx);
}

// Called at the end of each detached stripe-I/O thread.
void stripe_io_exit(Node* node, const std::shared_ptr<Link>& link,
                    int sidx) {
  if (--link->stripe_io[sidx] == 0) ::close(link->stripe_fd[sidx]);
  --node->active_threads;
}

// Re-enqueue a message whose stripe died before (or during) its write: a
// surviving stripe picks it up, same stripe-seq — the receiver's window
// dedups if the dead socket had in fact delivered it. Dropped (released
// by the destructor) only if the whole link is gone.
void requeue_msg(Node* node, const std::shared_ptr<Link>& link,
                 OutMsg&& m) {
  link->reroutes++;
  while (link->alive && !node->closing) {
    if (link->sendq.push(std::move(m), 0.1)) return;
  }
}

// ---- r14 shm lane I/O ----------------------------------------------------

// Write one [u32 len][u64 sseq][payload] record into the link's shm tx
// ring, streaming payload chunks as the reader frees space (a message
// larger than the ring flows through it). While blocked on a full ring,
// keepalives are injected on the TCP control socket so the lane's
// backpressure never reads as link silence at the peer's liveness timer;
// *last_tcp is the time of this sender's last TCP write, which each
// keepalive advances. Returns false when the link/segment died mid-write.
bool shm_write_record(Node* node, const std::shared_ptr<Link>& link,
                      stshm::Lane* sl, int fd, uint64_t sseq,
                      const uint8_t* payload, size_t len,
                      Clock::time_point* last_tcp) ST_EXCLUDES(sl->tx_mu) {
  StLockGuard wlk(sl->tx_mu);  // writer-promotion window (Lane::tx_mu)
  stshm::RingCtl& rc = sl->tx_ctl();
  uint8_t* base = sl->tx_data();
  const uint32_t rb = sl->ring_bytes;
  uint64_t head = rc.head.load(std::memory_order_relaxed);

  auto push_bytes = [&](const uint8_t* src, size_t n) -> bool {
    while (n > 0) {
      if (!link->alive || node->closing ||
          sl->hdr->closed.load(std::memory_order_relaxed))
        return false;
      uint64_t tail = rc.tail.load(std::memory_order_acquire);
      size_t free_b = (size_t)rb - (size_t)(head - tail);
      if (free_b == 0) {
        // spin-before-sleep, then a BOUNDED futex nap (teardown works by
        // waking these words, but the bound means a lost wake costs
        // 100 ms, never a hang)
        bool moved = false;
        for (int s = 0; s < stshm::kSpins; s++) {
          if (rc.tail.load(std::memory_order_acquire) != tail) {
            moved = true;
            break;
          }
#if defined(__x86_64__)
          __builtin_ia32_pause();
#endif
        }
        if (!moved) {
          sl->tx_waits.fetch_add(1, std::memory_order_relaxed);
          uint32_t seq = rc.tail_seq.load(std::memory_order_acquire);
          rc.wr_waiting.fetch_add(1, std::memory_order_seq_cst);
          if (rc.tail.load(std::memory_order_acquire) == tail)
            stshm::futex_wait(&rc.tail_seq, seq, 100);
          rc.wr_waiting.fetch_sub(1, std::memory_order_relaxed);
          auto now = Clock::now();
          if (std::chrono::duration<double>(now - *last_tcp).count() >=
              node->cfg.keepalive_sec) {
            uint8_t z[4] = {0, 0, 0, 0};
            if (!write_full(fd, z, 4)) return false;
            link->bytes_out += 4;
            *last_tcp = now;
          }
        }
        continue;
      }
      size_t c = std::min(free_b, n);
      stshm::ring_put(base, rb, head, src, c);
      head += c;
      src += c;
      n -= c;
#if defined(__x86_64__) && defined(__SSE2__) && !defined(ST_ANALYZE_NO_SIMD)
      _mm_sfence();  // NT stores must drain before the head publish
#endif
      rc.head.store(head, std::memory_order_release);
      rc.head_seq.fetch_add(1, std::memory_order_seq_cst);
      if (rc.rd_waiting.load(std::memory_order_seq_cst))
        stshm::futex_wake_all(&rc.head_seq);
    }
    return true;
  };

  uint8_t hdr[stshm::kRecHdr];
  uint32_t l32 = (uint32_t)len;
  std::memcpy(hdr, &l32, 4);
  std::memcpy(hdr + 4, &sseq, 8);
  // fast path: the whole record fits the free span — ONE publish (and at
  // most one wake) instead of separate header/payload publishes, so the
  // reader wakes once per record, not once per part
  {
    uint64_t tail = rc.tail.load(std::memory_order_acquire);
    if ((size_t)rb - (size_t)(head - tail) >= stshm::kRecHdr + len) {
      stshm::ring_put(base, rb, head, hdr, stshm::kRecHdr);
      if (len > 0)
        stshm::ring_put(base, rb, head + stshm::kRecHdr, payload, len);
      head += stshm::kRecHdr + len;
#if defined(__x86_64__) && defined(__SSE2__) && !defined(ST_ANALYZE_NO_SIMD)
      _mm_sfence();  // NT stores must drain before the head publish
#endif
      rc.head.store(head, std::memory_order_release);
      rc.head_seq.fetch_add(1, std::memory_order_seq_cst);
      if (rc.rd_waiting.load(std::memory_order_seq_cst))
        stshm::futex_wake_all(&rc.head_seq);
      return true;
    }
  }
  if (!push_bytes(hdr, stshm::kRecHdr)) return false;
  if (len > 0 && !push_bytes(payload, len)) return false;
  return true;
}

// Drain the link's shm rx ring. Records re-enter the EXACT delivery path
// the sockets use — striped links through the sseq reassembly window
// (TCP in-flights and ring records interleave correctly), unstriped
// straight into recvq in ring order, gated on the SWITCH marker
// (Lane::rx_go). Exits — and tears the link down, idempotently — on
// teardown or a corrupt record.
void shm_rx_loop(Node* node, std::shared_ptr<Link> link) {
  stshm::Lane* sl = link->shm.load(std::memory_order_acquire);
  stshm::RingCtl& rc = sl->rx_ctl();
  const uint8_t* base = sl->rx_data();
  const uint32_t rb = sl->ring_bytes;
  uint64_t tail = rc.tail.load(std::memory_order_relaxed);
  const bool striped = link->nstripes > 1;

  // A served lane whose joiner never validates (boot-id collision, map
  // failure — the documented keep-TCP fallback) must not cost a polling
  // thread and a parked segment for the link's lifetime: past this
  // deadline the creator closes the lane (tx can never activate on a
  // closed header — a straggler joiner just stays on TCP too), reclaims
  // the segment name, and this thread exits. 30 s dwarfs any legitimate
  // join handshake.
  const auto orphan_deadline = Clock::now() + std::chrono::seconds(30);
  auto orphan_expired = [&]() -> bool {
    return sl->creator != 0 &&
           sl->hdr->joined.load(std::memory_order_acquire) == 0 &&
           Clock::now() > orphan_deadline;
  };

  auto wait_avail = [&](size_t need) -> bool {
    while (link->alive && !node->closing) {
      if (orphan_expired()) return false;
      uint64_t head = rc.head.load(std::memory_order_acquire);
      if (head - tail >= need) return true;
      if (sl->hdr->closed.load(std::memory_order_relaxed))
        return false;  // checked AFTER head: drain what was published
      bool moved = false;
      for (int s = 0; s < stshm::kSpins; s++) {
        if (rc.head.load(std::memory_order_acquire) != head) {
          moved = true;
          break;
        }
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
      }
      if (moved) continue;
      sl->rx_waits.fetch_add(1, std::memory_order_relaxed);
      uint32_t seq = rc.head_seq.load(std::memory_order_acquire);
      rc.rd_waiting.fetch_add(1, std::memory_order_seq_cst);
      if (rc.head.load(std::memory_order_acquire) == head)
        stshm::futex_wait(&rc.head_seq, seq, 100);
      rc.rd_waiting.fetch_sub(1, std::memory_order_relaxed);
    }
    return false;
  };
  auto consume = [&](size_t n) {
    tail += n;
    rc.tail.store(tail, std::memory_order_release);
    rc.tail_seq.fetch_add(1, std::memory_order_seq_cst);
    if (rc.wr_waiting.load(std::memory_order_seq_cst))
      stshm::futex_wake_all(&rc.tail_seq);
  };

  // Optional delivery coalescing (ST_SHM_COALESCE_US, default OFF): hold
  // delivery until a few COMPLETE records are present or the window
  // expires, then deliver back-to-back. Measured on this box it LOSES —
  // the steady state is a closed loop paced by the go-back-N window, so
  // any delivery delay delays ACKs and stalls the producer (65 Ki:
  // 23.3 k f/s at hold 0 vs 19.4 k at 5 ms) — but the lever is the
  // first thing to re-try on a box where consumer-side pass amortization
  // dominates, so it stays env-gated rather than deleted.
  static const uint64_t kHoldNs = [] {
    const char* e = getenv("ST_SHM_COALESCE_US");
    long us = e && *e ? atol(e) : 0;
    if (us < 0) us = 0;
    if (us > 50000) us = 50000;
    return (uint64_t)us * 1000u;
  }();
  constexpr int kHoldMsgs = 4;
  // complete records currently in the ring (capped at kHoldMsgs); walks
  // record headers ahead of `tail` without consuming
  auto complete_records = [&]() -> int {
    uint64_t head = rc.head.load(std::memory_order_acquire);
    uint64_t pos = tail;
    int cnt = 0;
    while (cnt < kHoldMsgs && pos + stshm::kRecHdr <= head) {
      uint8_t lh[4];
      stshm::ring_get(base, rb, pos, lh, 4);
      uint32_t l;
      std::memcpy(&l, lh, 4);
      if (l > kMaxPayload) return cnt + 1;  // corrupt: let delivery red it
      if (pos + stshm::kRecHdr + l > head) break;
      cnt++;
      pos += stshm::kRecHdr + l;
    }
    return cnt;
  };
  // read + deliver ONE record; 0 = delivered, 1 = teardown, 2 = corrupt
  auto deliver_one = [&]() -> int {
    if (!wait_avail(stshm::kRecHdr)) return 1;
    uint8_t h[stshm::kRecHdr];
    stshm::ring_get(base, rb, tail, h, stshm::kRecHdr);
    uint32_t len;
    uint64_t sseq;
    std::memcpy(&len, h, 4);
    std::memcpy(&sseq, h + 4, 8);
    if (len > kMaxPayload) return 2;  // corrupt ring
    consume(stshm::kRecHdr);
    bool hit = false;
    std::vector<uint8_t> frame = link->rx_pool.get(&hit);
    node->rx_acquires++;
    if (!hit) node->rx_pool_misses++;
    frame.resize(len);
    size_t got = 0;
    while (got < len) {
      if (!wait_avail(1)) return 1;  // mid-record teardown
      uint64_t head = rc.head.load(std::memory_order_acquire);
      size_t n = std::min((size_t)(head - tail), len - got);
      stshm::ring_get(base, rb, tail, frame.data() + got, n);
      got += n;
      consume(n);
    }
    link->bytes_in += stshm::kRecHdr + len;
    link->frames_in++;
    sl->msgs_in.fetch_add(1, std::memory_order_relaxed);
    sl->bytes_in.fetch_add(stshm::kRecHdr + len, std::memory_order_relaxed);
    if (striped) {
      if (!deliver_striped(node, link, sseq, std::move(frame))) return 1;
      return 0;
    }
    while (link->alive && !node->closing) {
      if (link->recvq.push(std::move(frame), 0.5)) {
        node->notify_data();
        return 0;
      }
    }
    return 1;
  };

  bool clean = false;
  while (link->alive && !node->closing) {
    if (orphan_expired()) {
      clean = true;  // the LINK stays up on TCP; only the lane dies
      break;
    }
    if (!sl->rx_go.load(std::memory_order_acquire)) {
      // unstriped pre-marker window: records may already sit in the ring;
      // they wait for the marker's in-stream ordering point
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
      continue;
    }
    if (!wait_avail(stshm::kRecHdr)) {
      clean = true;
      break;
    }
    int avail = complete_records();
    if (kHoldNs > 0 && avail >= 1 && avail < kHoldMsgs) {
      uint64_t t0 = stobs::now_ns();
      while (avail < kHoldMsgs && link->alive && !node->closing &&
             !sl->hdr->closed.load(std::memory_order_relaxed) &&
             stobs::now_ns() - t0 < kHoldNs) {
        uint32_t seq = rc.head_seq.load(std::memory_order_acquire);
        uint64_t h0 = rc.head.load(std::memory_order_acquire);
        rc.rd_waiting.fetch_add(1, std::memory_order_seq_cst);
        if (rc.head.load(std::memory_order_acquire) == h0)
          stshm::futex_wait(&rc.head_seq, seq, 1);
        rc.rd_waiting.fetch_sub(1, std::memory_order_relaxed);
        avail = complete_records();
      }
    }
    if (avail < 1) avail = 1;  // first record still streaming: deliver now
    int rcod = 0;
    for (int r = 0; r < avail && rcod == 0; r++) rcod = deliver_one();
    if (rcod == 1) {
      clean = true;
      break;
    }
    if (rcod == 2) break;  // corrupt ring: kill the link below
  }
  if (orphan_expired()) {
    // never joined: close the lane (tx can then never activate on
    // either side) and reclaim the segment name now, not at link death
    sl->close_and_wake();
    if (!sl->name.empty()) {
      std::string p = "/dev/shm/" + sl->name;
      ::unlink(p.c_str());  // ~Lane's retry sees ENOENT, harmless
    }
  }
  if (!clean && link->alive && !node->closing) {
    // corrupt record length: the lane is unusable — tear the whole link
    // down (idempotent) so go-back-N recovers on a fresh link
    kill_link(node, link);
  }
  node->notify_data();  // wake blocked consumers to observe any death
  --node->active_threads;
}

// Submit nm stream messages with as few sendmmsg calls as possible. On a
// blocking socket each sendmsg completes fully except when interrupted by
// a signal mid-copy — the sender threads block ALL signals precisely so
// that cannot happen; the last completed message still gets a
// finish-the-remainder writev as belt-and-braces, and a short write on
// any EARLIER message of a batch (impossible with signals blocked) is a
// sheared stream — fail the link rather than continue it.
bool sendmmsg_full(int fd, struct mmsghdr* mm, int nm) {
  int done = 0;
  while (done < nm) {
    int r = ::sendmmsg(fd, mm + done, (unsigned)(nm - done), 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;
    for (int i = done; i < done + r; i++) {
      struct msghdr* mh = &mm[i].msg_hdr;
      size_t total = 0;
      for (size_t v = 0; v < mh->msg_iovlen; v++)
        total += mh->msg_iov[v].iov_len;
      size_t sent = mm[i].msg_len;
      if (sent == total) continue;
      if (i != done + r - 1) return false;  // sheared mid-batch: kill link
      struct iovec* iov = mh->msg_iov;
      int cnt = (int)mh->msg_iovlen;
      size_t n = sent;
      while (cnt > 0 && n >= iov->iov_len) {
        n -= iov->iov_len;
        iov++;
        cnt--;
      }
      if (cnt > 0) {
        iov->iov_base = (uint8_t*)iov->iov_base + n;
        iov->iov_len -= n;
        if (!writev_full(fd, iov, cnt)) return false;
      }
    }
    done += r;
  }
  return true;
}

void link_sender_loop(Node* node, std::shared_ptr<Link> link, int sidx) {
  const bool striped = link->nstripes > 1;
  const int fd = link->stripe_fd[sidx];
  // token bucket for the bandwidth cap (reference README.md:31 TODO);
  // striped links split the budget evenly across stripe senders
  double tokens = 0;
  auto last = Clock::now();
  // this stripe's last write to its socket: on a lane link the ring takes
  // the data, and the socket must still carry a keepalive every
  // keepalive_sec (see the lane's Liveness note)
  auto last_tcp = Clock::now();
  const int64_t cap =
      node->cfg.bandwidth_cap_bps / (striped ? link->nstripes : 1);
  const FaultPlan& fp = node->cfg.fault;

  // sendmmsg shear guard (see sendmmsg_full): a signal landing mid-sendmsg
  // could short-write one message of a batch; these detached I/O threads
  // never run Python signal handlers anyway (CPython delivers to the main
  // thread), so block everything here.
  {
    sigset_t all;
    sigfillset(&all);
    pthread_sigmask(SIG_BLOCK, &all, nullptr);
  }
  OutMsg msg;
  while (link->alive && link->stripe_ok[sidx].load() && !node->closing) {
    // r14 shm lane: once live, the lane's single writer is the
    // lowest-index LIVE stripe's sender (promotes on stripe death;
    // Lane::tx_mu covers the brief overlap); every other stripe sender
    // stops popping data and only keeps its socket's liveness flowing —
    // TCP stays the control/teardown channel.
    stshm::Lane* sl = node->cfg.wire_compat
                          ? nullptr
                          : link->shm.load(std::memory_order_acquire);
    const bool shm_tx = sl != nullptr && sl->tx_ready();
    if (shm_tx) {
      int wr = 0;
      while (wr < link->nstripes && !link->stripe_ok[wr].load()) wr++;
      if (wr != sidx) {
        // short-sliced idle so a writer-stripe death PROMOTES promptly
        // (one uninterruptible keepalive_sec nap here froze the data
        // plane for up to ~1 s per writer death); the keepalive itself
        // still flows at keepalive cadence
        auto ka_deadline =
            Clock::now() +
            std::chrono::duration<double>(node->cfg.keepalive_sec);
        bool promoted = false;
        while (Clock::now() < ka_deadline) {
          std::this_thread::sleep_for(std::chrono::milliseconds(20));
          if (!link->alive || node->closing ||
              !link->stripe_ok[sidx].load())
            break;
          int w2 = 0;
          while (w2 < link->nstripes && !link->stripe_ok[w2].load()) w2++;
          if (w2 == sidx) {
            promoted = true;  // the writer role fell to us: resume popping
            break;
          }
        }
        if (!link->alive || node->closing || !link->stripe_ok[sidx].load())
          break;
        if (promoted) continue;
        uint8_t z[4] = {0, 0, 0, 0};
        if (!write_full(fd, z, 4)) break;
        link->bytes_out += 4;
        last_tcp = Clock::now();
        continue;
      }
    }
    bool have = link->sendq.pop(&msg, node->cfg.keepalive_sec);
    if (!link->alive || node->closing) break;
    if (!link->stripe_ok[sidx].load()) {
      if (have && striped) requeue_msg(node, link, std::move(msg));
      break;
    }
    if (!have) {
      // idle: emit liveness traffic on THIS stripe. Native: zero-length
      // keepalive frame (4 bytes, never a stripe seq). Compat: a
      // zero-scale codec frame — the reference's own idle behavior
      // (quirk Q2), which its peers expect.
      msg.reset();
      bool kok;
      if (node->cfg.wire_compat) {
        bool hit;
        msg.owned = link->tx_pool.get(&hit);
        msg.owned.assign((size_t)node->cfg.compat_frame_bytes, 0);
        kok = write_full(fd, msg.owned.data(), msg.owned.size());
        link->bytes_out += msg.owned.size();
        if (msg.owned.capacity()) {
          link->tx_pool.put(std::move(msg.owned));
          msg.owned = std::vector<uint8_t>();
        }
      } else {
        uint8_t z[4] = {0, 0, 0, 0};
        kok = write_full(fd, z, 4);
        link->bytes_out += 4;
      }
      if (!kok) break;
      last_tcp = Clock::now();
      continue;
    }
    // ---- fault injection at the wire boundary (Config::fault; the
    // Python tier injects the identical classes in peer._send_blocking).
    // Data frames only: native kind 0/7/11 (incl. the r11 0x80 precision
    // bit), or any queued payload in compat mode. Keepalives are
    // liveness, not data — chaos never silences liveness. Stripe senders
    // share the per-link schedule state under fault_mu (plan-enabled
    // builds only); only_stripe >= 0 confines every class to that stripe.
    size_t write_len = msg.size();
    int write_reps = 1;
    if (fp.enabled) {
      const uint8_t* d = msg.data();
      uint8_t kind0 = msg.size() > 0 ? (uint8_t)(d[0] & 0x7F) : 0xFF;
      // data kinds the chaos classes cover: DATA, BURST, RDATA, and the
      // r16 owner-routed FWD (17) — the sharded tree's whole data plane
      // rides FWD frames, so leaving it out would silently exempt every
      // sharded cluster from wire chaos (tools/lint_wire.py pins this
      // literal set against wire.py's data kinds)
      bool is_data = node->cfg.wire_compat ||
                     (msg.size() > 0 &&
                      (kind0 == 0 || kind0 == 7 || kind0 == 11 ||
                       kind0 == 17));
      if (is_data && (fp.only_link <= 0 || link->id == fp.only_link) &&
          (fp.only_stripe < 0 || sidx == fp.only_stripe)) {
        StUniqueLock flk(link->fault_mu);
        if (!link->fault_rng)
          link->fault_rng =
              (fp.seed + 1) * 0x9e3779b97f4a7c15ull + (uint64_t)link->id;
        int64_t nf = ++link->fault_frames;
        uint64_t* rng = &link->fault_rng;
        if (fp.sever_after > 0 && nf >= fp.sever_after) {
          st_obs_emit(node->obs_id, stobs::kEvFaultSever, link->id,
                      (uint64_t)nf);
          flk.unlock();
          if (striped && fp.only_stripe >= 0) {
            // per-stripe sever: THIS socket dies, the link degrades to
            // the surviving stripes; the in-hand message re-routes.
            // Kill the stripe FIRST: if this was the LAST stripe, the
            // link dies and requeue_msg drops instead of spinning on a
            // full sendq no surviving sender will ever drain.
            kill_stripe(node, link, sidx);
            requeue_msg(node, link, std::move(msg));
            break;
          }
          kill_link(node, link);
          break;
        }
        if (fp.stall_after >= 0 && nf > fp.stall_after) {
          // swallowed: sender layers believe it was delivered (a borrowed
          // slot is still released — via msg's reuse/destruction). On a
          // striped link the swallowed stripe seq additionally wedges
          // reassembly, so the link presents as a black hole until the
          // engine's go-back-N tears it down — the stall contract.
          st_obs_emit(node->obs_id, stobs::kEvFaultStall, link->id,
                      (uint64_t)nf);
          msg.reset();
          continue;
        }
        if (fp.delay_pct > 0 && frand64(rng) < fp.delay_pct) {
          st_obs_emit(node->obs_id, stobs::kEvFaultDelay, link->id,
                      (uint64_t)fp.delay_ms);
          flk.unlock();
          std::this_thread::sleep_for(
              std::chrono::duration<double>(fp.delay_ms / 1000.0));
          flk.lock();
        }
        if (fp.drop > 0 && frand64(rng) < fp.drop) {
          st_obs_emit(node->obs_id, stobs::kEvFaultDrop, link->id,
                      (uint64_t)nf);
          if (!striped) {
            msg.reset();
            continue;
          }
          // striped links must not leave a HOLE in the stripe-seq space
          // (reassembly would wedge the whole link on one injected drop):
          // a dropped message goes out as a 1-byte runt instead — the
          // receiver's decode rejects it without consuming the ENGINE
          // seq, so recovery is the same go-back-N retransmission as a
          // true drop.
          write_len = 1;
        }
        if (fp.corrupt > 0 && msg.size() > 1 && write_len > 1 &&
            frand64(rng) < fp.corrupt) {
          // flip one bit past the kind byte: lands in scales/words, the
          // receiver's decode-guard trust boundary. COPY-ON-WRITE for a
          // borrowed (zero-copy) payload: its bytes ARE the engine's
          // retransmission ledger entry, which must stay byte-identical —
          // corrupting in place would poison every future retransmit of
          // the same message (and the rollback math).
          if (msg.zdata) {
            msg.owned.assign(msg.zdata, msg.zdata + msg.zlen);
            msg.zdata = nullptr;  // release still fires at reset()
            msg.zlen = 0;
          }
          size_t i = 1 + (size_t)(frand64(rng) * (msg.owned.size() - 1));
          if (i >= msg.owned.size()) i = msg.owned.size() - 1;
          msg.owned[i] ^= (uint8_t)(1u << (int)(frand64(rng) * 8));
          st_obs_emit(node->obs_id, stobs::kEvFaultCorrupt, link->id,
                      (uint64_t)i);
        }
        if (fp.trunc > 0 && !node->cfg.wire_compat && msg.size() > 2 &&
            write_len == msg.size() && frand64(rng) < fp.trunc) {
          // well-framed SHORT message (header announces the truncated
          // length): the receiver decodes, rejects, and ACKs it —
          // bounded per-frame loss, not a stream shear. Compat framing
          // is fixed-size, so truncation there would desync every later
          // frame; disabled.
          write_len = 1 + (size_t)(frand64(rng) * (msg.size() - 1));
          if (write_len > msg.size()) write_len = msg.size();
          st_obs_emit(node->obs_id, stobs::kEvFaultTruncate, link->id,
                      (uint64_t)write_len);
        }
        // dup gated off compat like trunc: the reference protocol has no
        // seq dedup, so a duplicated compat frame would double-apply with
        // no recovery path (comm/faults.py FaultPlan.wire_compat)
        if (fp.dup > 0 && !node->cfg.wire_compat &&
            frand64(rng) < fp.dup) {
          write_reps = 2;
          st_obs_emit(node->obs_id, stobs::kEvFaultDup, link->id,
                      (uint64_t)nf);
        }
      }
    }
    if (cap > 0 && msg.size() > 0) {
      auto now = Clock::now();
      tokens += std::chrono::duration<double>(now - last).count() * (double)cap;
      // burst allowance: 100ms worth, so the cap is honored even for the
      // first frames after an idle period
      if (tokens > 0.1 * (double)cap) tokens = 0.1 * (double)cap;
      last = now;
      if ((double)msg.size() > tokens) {
        double wait = ((double)msg.size() - tokens) / (double)cap;
        std::this_thread::sleep_for(std::chrono::duration<double>(wait));
        tokens = 0;
        last = Clock::now();  // the slept interval is spent, not re-credited
      } else {
        tokens -= (double)msg.size();
      }
    }
    // ---- r14 shm lane send path: the message's bytes go straight from
    // the borrowed tx slot (or owned buffer) into the ring record — the
    // zero-copy TxSlot handoff into shm; the fault injector above already
    // ran PER MESSAGE (runt/corrupt/dup/stall/sever), exactly as on the
    // TCP lanes, so chaos coverage is lane-independent.
    if (shm_tx) {
      if (!striped && !sl->marker_sent.exchange(true)) {
        // SWITCH marker: the last data-plane byte this link sends on TCP
        // — the receiver enables ring delivery at exactly this point in
        // the stream (striped links need no marker: ring records carry
        // stripe seqs into the same reassembly window as the sockets)
        uint8_t mk[4];
        uint32_t ml = stshm::kShmSwitchLen;
        std::memcpy(mk, &ml, 4);
        if (!write_full(fd, mk, 4)) break;
        link->bytes_out += 4;
        last_tcp = Clock::now();
      }
      if (!sl->ev_emitted.exchange(true))
        st_obs_emit(node->obs_id, stobs::kEvShmLaneUp, link->id,
                    (uint64_t)sl->ring_bytes);
      bool sok = true;
      for (int rep = 0; rep < write_reps && sok; rep++) {
        uint64_t sq = msg.sseq;
        size_t wl = write_len;
        if (rep > 0) {
          // injected duplicate: a NEW transport message (fresh stripe
          // seq) carrying the same engine payload, like the TCP path
          sq = link->sseq_next.fetch_add(1, std::memory_order_relaxed);
          wl = msg.size();
        }
        sok = shm_write_record(node, link, sl, fd, sq, msg.data(), wl,
                               &last_tcp);
        if (sok) {
          sl->msgs_out.fetch_add(1, std::memory_order_relaxed);
          sl->bytes_out.fetch_add(stshm::kRecHdr + wl,
                                  std::memory_order_relaxed);
        }
      }
      if (!sok) break;  // lane/link died mid-write: normal teardown path
      link->frames_out += 1;
      link->bytes_out += msg.size() + stshm::kRecHdr;
      // TCP liveness under a busy ring: the idle keepalive above fires
      // only after a whole keepalive_sec with nothing queued
      auto now = Clock::now();
      if (std::chrono::duration<double>(now - last_tcp).count() >=
          node->cfg.keepalive_sec) {
        uint8_t z[4] = {0, 0, 0, 0};
        if (!write_full(fd, z, 4)) break;
        link->bytes_out += 4;
        last_tcp = now;
      }
      if (msg.release) {
        msg.reset();
      } else if (msg.owned.capacity()) {
        link->tx_pool.put(std::move(msg.owned));
        msg.owned = std::vector<uint8_t>();
      }
      continue;
    }
    // ---- batched submission (r11 writev -> r14 sendmmsg): on the clean
    // native path (no fault plan, no pacing) opportunistically gather
    // more queued messages and put the whole batch through ONE kernel
    // crossing — each message keeps its own mmsghdr (length prefix,
    // stripe seq and payload iovecs; borrowed ring slots gather without
    // copies), so the syscall/wakeup cost amortizes across the batch and
    // partial completion stays per-message (sendmmsg_full).
    OutMsg batch[kCoalesce];
    int nb = 1;
    batch[0] = std::move(msg);
    if (!node->cfg.wire_compat && !fp.enabled && cap <= 0) {
      const int bmax = link->batch_max.load(std::memory_order_relaxed);
      while (nb < bmax && link->sendq.pop(&batch[nb], 0.0)) nb++;
    }
    bool ok = true;
    if (node->cfg.wire_compat) {
      for (int rep = 0; rep < write_reps && ok; rep++)
        ok = write_full(fd, batch[0].data(), write_len);
    } else {
      // striped framing: [u32 len][u64 sseq][payload]; legacy: [len][..]
      uint8_t hdrs[2 * kCoalesce][12];
      struct iovec iov[4 * kCoalesce];
      struct mmsghdr mm[2 * kCoalesce];
      std::memset(mm, 0, sizeof mm);
      int niov = 0, nh = 0, nm = 0;
      for (int rep = 0; rep < write_reps; rep++) {
        for (int i = 0; i < nb; i++) {
          size_t wl = i == 0 ? write_len : batch[i].size();
          uint64_t sq = batch[i].sseq;
          if (rep > 0) {
            // an injected duplicate is a NEW transport message (fresh
            // stripe seq) carrying the same engine payload — the
            // engine-level dedup is what the fault exercises, and the
            // stripe window must not swallow it first
            sq = link->sseq_next.fetch_add(1, std::memory_order_relaxed);
          }
          uint8_t* H = hdrs[nh++];
          uint32_t len = (uint32_t)wl;
          std::memcpy(H, &len, 4);
          size_t hlen = 4;
          if (striped) {
            std::memcpy(H + 4, &sq, 8);
            hlen = 12;
          }
          int first = niov;
          iov[niov].iov_base = H;
          iov[niov].iov_len = hlen;
          niov++;
          if (wl) {
            iov[niov].iov_base = (void*)batch[i].data();
            iov[niov].iov_len = wl;
            niov++;
          }
          mm[nm].msg_hdr.msg_iov = &iov[first];
          mm[nm].msg_hdr.msg_iovlen = (size_t)(niov - first);
          nm++;
        }
      }
      ok = sendmmsg_full(fd, mm, nm);
    }
    if (ok) {
      last_tcp = Clock::now();
      for (int i = 0; i < nb; i++) {
        // compat: one queued payload may carry K concatenated fixed-size
        // frames (the engine's compat bursts) — count the frames actually
        // put on the wire, so sender wire counts reconcile with both the
        // receiver's per-frame re-framing and the engine's per-frame
        // delivery counters (peer.metrics() taxonomy).
        link->frames_out +=
            node->cfg.wire_compat
                ? batch[i].size() / (size_t)node->cfg.compat_frame_bytes
                : 1;
        link->bytes_out += batch[i].size() +
                           (node->cfg.wire_compat ? 0 : (striped ? 12 : 4));
        // recycle: borrowed slots go back to their ring (reset ->
        // release); owned buffers to the link's tx free-list
        if (batch[i].release) {
          batch[i].reset();
        } else if (batch[i].owned.capacity()) {
          link->tx_pool.put(std::move(batch[i].owned));
          batch[i].owned = std::vector<uint8_t>();
        }
      }
    } else {
      if (striped) {
        // the socket died mid-batch: every message in hand re-routes to
        // the surviving stripes (delivery-uncertain ones dedup at the
        // receiver's reassembly window). Kill the stripe BEFORE
        // requeueing: if this was the LAST stripe the link dies with it
        // and requeue_msg drops the batch instead of livelocking on a
        // full sendq that no surviving sender thread will ever drain
        // (go-back-N re-delivers after the re-graft either way).
        kill_stripe(node, link, sidx);
        for (int i = 0; i < nb; i++)
          requeue_msg(node, link, std::move(batch[i]));
      }
      break;
    }
  }
  // a message popped (or half-processed) when the stripe died is released
  // by msg's/batch's destructors (or re-routed above); messages still
  // queued are released when the Link — and with it the sendq deque — is
  // destroyed after every I/O thread exits
  kill_stripe(node, link, sidx);
  stripe_io_exit(node, link, sidx);
}

// Deliver one striped message into the link's in-order stream: park it in
// the reorder map, then drain the consecutive run into recvq (one elected
// drainer at a time — `delivering`). Returns false when the link must die
// (queue closed under us).
bool deliver_striped(Node* node, const std::shared_ptr<Link>& link,
                     uint64_t sseq, std::vector<uint8_t>&& frame) {
  StUniqueLock lk(link->rmu);
  // window backpressure: a stripe that runs too far ahead of the in-order
  // point blocks here (bounding reassembly memory) until delivery
  // advances — or its own liveness timeout kills it if rnext's stripe is
  // truly dead
  while (link->alive && !node->closing &&
         sseq > link->rnext + kReorderWindow) {
    link->rcv.wait_until(lk.native(), st_cv_deadline(0.1));
  }
  if (!link->alive || node->closing) return false;
  if (sseq < link->rnext || link->reorder.count(sseq)) {
    // duplicate of an already-delivered/parked message (a re-routed
    // write whose first copy did land): drop, recycle the buffer
    link->rx_pool.put(std::move(frame));
    return true;
  }
  link->reorder.emplace(sseq, std::move(frame));
  if (link->delivering) return true;
  link->delivering = true;
  while (!link->reorder.empty()) {
    auto it = link->reorder.begin();
    if (it->first < link->rnext) {
      // a re-routed duplicate of the message the drainer had in flight
      // (sseq == rnext while the lock was dropped for the recvq push, so
      // the dedup check above missed it): already delivered — drop it,
      // or this stale head blocks the == rnext test below forever
      link->rx_pool.put(std::move(it->second));
      link->reorder.erase(it);
      continue;
    }
    if (it->first != link->rnext) break;
    std::vector<uint8_t> f = std::move(it->second);
    link->reorder.erase(it);
    lk.unlock();
    bool pushed = false;
    while (link->alive && !node->closing) {
      if (link->recvq.push(std::move(f), 0.5)) {
        node->notify_data();
        pushed = true;
        break;
      }
    }
    lk.lock();
    if (!pushed) {
      link->delivering = false;
      return false;
    }
    link->rnext++;
    link->rcv.notify_all();  // window waiters may proceed
  }
  link->delivering = false;
  return true;
}

void link_receiver_loop(Node* node, std::shared_ptr<Link> link, int sidx) {
  const bool striped = link->nstripes > 1;
  const int fd = link->stripe_fd[sidx];
  uint64_t ring_seen = 0;  // the lane's records at the last timeout
  while (link->alive && link->stripe_ok[sidx].load() && !node->closing) {
    // decode-side pool (r07): recycle rx buffers through the free list so
    // the steady state reads into warm, already-sized memory — the old
    // fresh-vector-per-message path paid an allocation plus page faults
    // per message (16+ MiB at large-table bursts)
    bool hit = false;
    std::vector<uint8_t> frame = link->rx_pool.get(&hit);
    node->rx_acquires++;
    if (!hit) node->rx_pool_misses++;
    uint64_t sseq = 0;
    if (node->cfg.wire_compat) {
      frame.resize((size_t)node->cfg.compat_frame_bytes);
      if (!read_full(fd, frame.data(), frame.size())) break;
    } else {
      uint8_t hdr[12];
      if (!read_prefix(fd, hdr, link->shm, &ring_seen)) break;
      uint32_t len = (uint32_t)hdr[0] | ((uint32_t)hdr[1] << 8) |
                     ((uint32_t)hdr[2] << 16) | ((uint32_t)hdr[3] << 24);
      if (len == stshm::kShmSwitchLen) {
        // r14 SWITCH marker (unstriped shm lane): every data message
        // before this point arrived on TCP in order; everything after is
        // in the ring — enable ring delivery at exactly this point. Only
        // ever sent after a successful shm attach, so a pre-r14 peer can
        // never see it.
        if (stshm::Lane* msl = link->shm.load(std::memory_order_acquire))
          msl->rx_go.store(true, std::memory_order_release);
        link->rx_pool.put(std::move(frame));
        continue;
      }
      if (len > kMaxPayload) break;  // protocol violation
      if (len == 0) {                // keepalive (no stripe seq)
        link->rx_pool.put(std::move(frame));
        continue;
      }
      if (striped) {
        if (!read_full(fd, hdr + 4, 8)) break;
        std::memcpy(&sseq, hdr + 4, 8);
      }
      frame.resize(len);
      if (!read_full(fd, frame.data(), len)) break;
    }
    link->bytes_in +=
        frame.size() + (node->cfg.wire_compat ? 0 : (striped ? 12 : 4));
    link->frames_in++;
    if (striped) {
      if (!deliver_striped(node, link, sseq, std::move(frame))) break;
      continue;
    }
    // Block if the consumer is behind: TCP backpressure then paces the
    // peer, exactly like the reference's blocking frame loop. Never drop:
    // frames are cumulative deltas.
    while (link->alive && !node->closing) {
      if (link->recvq.push(std::move(frame), 0.5)) {
        node->notify_data();
        break;
      }
    }
  }
  kill_stripe(node, link, sidx);
  node->notify_data();  // wake blocked consumers so they observe the death
  stripe_io_exit(node, link, sidx);
}

// ---- topology: listener (reference do_listening, src/sharedtensor.c:
// 192-242) ----------------------------------------------------------------

void listener_loop(Node* node, int listen_fd) {
  while (!node->closing) {
    sockaddr_in peer{};
    socklen_t plen = sizeof peer;
    int fd = ::accept(listen_fd, (sockaddr*)&peer, &plen);
    if (fd < 0) {
      if (errno == EINTR) continue;
      bool retired;
      {
        StLockGuard lk(node->mu);
        retired = listen_fd != node->listen_fd &&
                  listen_fd != node->regraft_listen_fd &&
                  listen_fd != node->rendezvous_listen_fd;
      }
      if (retired) {
        // a later re-graft replaced this listener and shut it down: its fd
        // is ours alone to close (st_node_close closes only the current
        // ones)
        ::close(listen_fd);
        break;
      }
      if (node->closing) break;
      continue;
    }
    if (node->closing) {
      ::close(fd);
      break;
    }
    set_common_sockopts(fd);

    bool v4 = false;
    int want_stripes = 1;
    if (!node->cfg.wire_compat) {
      // native hello: magic, then the magic-specific tail (STT3: u32
      // hint; STT4: u32 hint + u32 want_stripes; STTS: u64 token + u8
      // stripe idx — an extra socket attaching to an accepted link)
      uint8_t magic[4];
      set_recv_timeout(fd, 5.0);
      if (!read_full(fd, magic, 4)) {
        ::close(fd);
        continue;
      }
      if (memcmp(magic, kMagicS, 4) == 0) {
        uint8_t rest[9];
        if (!read_full(fd, rest, 9)) {
          ::close(fd);
          continue;
        }
        uint64_t token;
        std::memcpy(&token, rest, 8);
        int idx = rest[8];
        std::shared_ptr<Link> sl;
        {
          StLockGuard lk(node->mu);
          auto now = Clock::now();
          auto& ps = node->pending_stripes;
          for (size_t i = 0; i < ps.size();) {
            if (ps[i].deadline < now || !ps[i].link->alive) {
              ps.erase(ps.begin() + i);
              continue;
            }
            if (ps[i].token == token) sl = ps[i].link;
            i++;
          }
        }
        // reject any index EVER attached (fd stays >= 0 after death; only
        // this acceptor thread writes it for accepted links): a stripe
        // death is permanent by design, and a replayed STTS re-attaching
        // a dead index would reset stripe_io to 2 while the dead pair's
        // exits still owe decrements — driving the refcount to 0 early
        // and closing the NEW fd out from under its fresh I/O threads.
        if (!sl || idx < 1 || idx >= sl->nstripes || !sl->alive ||
            sl->stripe_fd[idx] >= 0) {
          ::close(fd);
          continue;
        }
        uint8_t yy = 'y';
        if (!write_full(fd, &yy, 1)) {
          ::close(fd);
          continue;
        }
        attach_stripe(node, sl, idx, fd);
        continue;
      }
      v4 = memcmp(magic, kMagic4, 4) == 0;
      if (!v4 && memcmp(magic, kMagic, 4) != 0) {
        ::close(fd);
        continue;
      }
      uint8_t rest[8];
      if (!read_full(fd, rest, v4 ? 8 : 4)) {
        ::close(fd);
        continue;
      }
      if (v4) {
        uint32_t w;
        std::memcpy(&w, rest + 4, 4);
        want_stripes =
            (int)(w < 1 ? 1 : (w > (uint32_t)kMaxStripes ? kMaxStripes : w));
      }
    }

    // free child slot? accept. Otherwise redirect down the tree,
    // alternating between children (reference :226-234).
    int slot = -1;
    std::shared_ptr<Link> redirect_to;
    {
      StLockGuard lk(node->mu);
      for (int i = 0; i < node->cfg.max_children; i++) {
        if (!node->child_slot[i]) {
          slot = i;
          break;
        }
      }
      if (slot < 0) {
        // pick an alternating live child for the redirect
        for (int t = 0; t < node->cfg.max_children; t++) {
          int i = (node->lrcounter++) % node->cfg.max_children;
          if (node->child_slot[i]) {
            redirect_to = node->child_slot[i];
            break;
          }
        }
      }
    }
    if (slot >= 0) {
      if (v4) {
        // STT4 accept: 'Y' + [u8 granted][u64 token]; the joiner opens
        // granted-1 extra sockets that attach via the STTS hello above
        uint64_t token;
        {
          StLockGuard lk(node->mu);
          node->token_rng ^= (uint64_t)fd * 0x9e3779b97f4a7c15ull;
          frand64(&node->token_rng);
          token = node->token_rng;
        }
        uint8_t reply[10];
        reply[0] = 'Y';
        reply[1] = (uint8_t)want_stripes;
        std::memcpy(reply + 2, &token, 8);
        if (!write_full(fd, reply, 10)) {
          ::close(fd);
          continue;
        }
        auto link = make_link(node, fd, /*is_uplink=*/0, &peer, want_stripes);
        StLockGuard lk(node->mu);
        node->child_slot[slot] = link;
        if (want_stripes > 1)
          node->pending_stripes.push_back(
              {token, link,
               Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                  std::chrono::seconds(15))});
      } else {
        uint8_t y = 'Y';
        if (!write_full(fd, &y, 1)) {
          ::close(fd);
          continue;
        }
        auto link = make_link(node, fd, /*is_uplink=*/0, &peer);
        StLockGuard lk(node->mu);
        node->child_slot[slot] = link;
      }
    } else if (redirect_to) {
      uint8_t n = 'N';
      sockaddr_in addr = redirect_to->peer_addr;
      write_full(fd, &n, 1);
      write_full(fd, (const uint8_t*)&addr, sizeof addr);
      ::close(fd);
    } else {
      ::close(fd);  // no children to redirect to and no slots (shutting down)
    }
  }
  --node->active_threads;
}

// ---- topology: join walk (reference connect_to, src/sharedtensor.c:
// 244-332) ----------------------------------------------------------------

// Walk the tree from the rendezvous until someone accepts us (O(log N)
// redirects). Returns connected fd + the local endpoint of that socket, or
// -1 with *became_master=true when nobody answers at the rendezvous.
int join_walk(Node* node, sockaddr_in target, bool allow_master,
              bool* became_master, sockaddr_in* local_endpoint,
              int* out_granted, uint64_t* out_token,
              sockaddr_in* out_final) {
  *became_master = false;
  if (out_granted) *out_granted = 1;
  if (out_token) *out_token = 0;
  // STT4 hello iff this node wants stripes (a pre-r11 acceptor rejects it
  // — explicit breakage, the magic-bump discipline; stripe_count=1 keeps
  // the r10 wire byte-for-byte)
  const bool v4 = !node->cfg.wire_compat && node->cfg.stripe_count > 1;
  for (int hops = 0; hops < 64; hops++) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    set_common_sockopts(fd);
    set_rcvbuf(fd, node->cfg.rcvbuf_bytes);
    // bounded per-hop connect (see connect_with_timeout): a dead or
    // silently-dropping target fails this hop after the bound instead of
    // hanging the join forever
    if (!connect_with_timeout(fd, &target, node->cfg.connect_timeout_sec)) {
      ::close(fd);
      if (hops == 0 && allow_master) {
        // nobody home at the rendezvous: we are the master (the reference's
        // master election, src/sharedtensor.c:271-277)
        *became_master = true;
        return -1;
      }
      return -1;
    }
    if (!node->cfg.wire_compat) {
      uint8_t hello[12];
      memcpy(hello, v4 ? kMagic4 : kMagic, 4);
      uint32_t hint = (uint32_t)node->cfg.compat_frame_bytes;
      memcpy(hello + 4, &hint, 4);
      if (v4) {
        uint32_t w = (uint32_t)node->cfg.stripe_count;
        memcpy(hello + 8, &w, 4);
      }
      if (!write_full(fd, hello, v4 ? 12 : 8)) {
        ::close(fd);
        return -1;
      }
    }
    // crash point: connected + hello'd, membership not yet granted
    st_fault_crash_point("mid-join-walk");
    uint8_t reply;
    // the reply read gets the same per-hop bound: an accepting-but-silent
    // peer (half-dead redirect target) must not wedge the walk
    set_recv_timeout(fd, node->cfg.connect_timeout_sec > 0
                             ? node->cfg.connect_timeout_sec
                             : 10.0);
    if (!read_full(fd, &reply, 1)) {
      ::close(fd);
      return -1;
    }
    if (reply == 'Y') {
      if (v4) {
        // STT4 accept tail: [u8 granted][u64 token]
        uint8_t ext[9];
        if (!read_full(fd, ext, 9)) {
          ::close(fd);
          return -1;
        }
        int g = ext[0];
        if (g < 1) g = 1;
        if (g > kMaxStripes) g = kMaxStripes;
        if (out_granted) *out_granted = g;
        if (out_token) std::memcpy(out_token, ext + 1, 8);
      }
      if (out_final) *out_final = target;
      socklen_t len = sizeof *local_endpoint;
      getsockname(fd, (sockaddr*)local_endpoint, &len);
      set_recv_timeout(fd, node->cfg.peer_timeout_sec);
      return fd;
    }
    if (reply != 'N') {
      ::close(fd);
      return -1;
    }
    sockaddr_in next{};
    if (!read_full(fd, (uint8_t*)&next, sizeof next)) {
      ::close(fd);
      return -1;
    }
    ::close(fd);
    target = next;
  }
  return -1;
}

// Open the granted-1 extra stripe sockets toward the accepting hop and
// attach each via the STTS hello. A stripe that fails to connect/ack is
// simply skipped — the link runs on whatever attached (degraded from
// birth beats no link).
void open_stripes(Node* node, const std::shared_ptr<Link>& link,
                  sockaddr_in target, uint64_t token, int granted) {
  for (int i = 1; i < granted && !node->closing && link->alive; i++) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) continue;
    set_common_sockopts(fd);
    set_rcvbuf(fd, node->cfg.rcvbuf_bytes);
    if (!connect_with_timeout(fd, &target, node->cfg.connect_timeout_sec)) {
      ::close(fd);
      continue;
    }
    uint8_t hello[13];
    memcpy(hello, kMagicS, 4);
    std::memcpy(hello + 4, &token, 8);
    hello[12] = (uint8_t)i;
    uint8_t ack = 0;
    set_recv_timeout(fd, node->cfg.connect_timeout_sec > 0
                             ? node->cfg.connect_timeout_sec
                             : 10.0);
    if (!write_full(fd, hello, 13) || !read_full(fd, &ack, 1) ||
        ack != 'y') {
      ::close(fd);
      continue;
    }
    attach_stripe(node, link, i, fd);
  }
}

// Listen at `addr` too (a re-graft's uplink endpoint: see
// Node::regraft_listen_fd). The previous re-graft's listener, if any, sees
// its accept fail and retires; the first join's listener stays. If `addr`
// cannot be bound, the listeners stay as they were.
void relisten(Node* node, const sockaddr_in& addr) {
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return;
  set_common_sockopts(lfd);
  if (::bind(lfd, (const sockaddr*)&addr, sizeof addr) != 0 ||
      ::listen(lfd, node->cfg.listen_backlog) != 0) {
    ::close(lfd);
    return;
  }
  int old;
  {
    // closing re-checked under mu, as for rendezvous_listen_fd: either
    // st_node_close sees the new fd, or we close it here
    StLockGuard lk(node->mu);
    if (node->closing) {
      ::close(lfd);
      return;
    }
    old = node->regraft_listen_fd;
    node->regraft_listen_fd = lfd;
  }
  node->active_threads += 1;
  std::thread(listener_loop, node, lfd).detach();
  if (old >= 0) ::shutdown(old, SHUT_RDWR);  // its listener_loop closes it
}

// Uplink died: re-graft through the rendezvous (fixes reference quirk Q8 —
// it exits instead). Children keep streaming throughout.
//
// MASTER FAILOVER: when the dead parent was the master itself, nobody
// answers at the rendezvous — every rejoin attempt gets connection-refused.
// An orphan then tries to BIND the rendezvous address and become the new
// master; the OS arbitrates the race between orphaned siblings
// (EADDRINUSE = a sibling won, whom the next join cycle will reach). Only
// a node that can neither join nor bind across two consecutive cycles is
// genuinely isolated (kind-4 event; Python surfaces the error). The
// reference cannot survive a master death at all (quirk Q8).
void rejoin_loop(Node* node) {
  int failed_cycles = 0;
  while (!node->closing) {
    {
      StUniqueLock lk(node->ev_mu);
      node->ev_cv.wait_until(lk.native(), st_cv_deadline(0.2));
    }
    if (node->closing) break;
    bool need;
    {
      StLockGuard lk(node->mu);
      need = !node->is_master && node->uplink_id < 0;
    }
    if (!need) {
      failed_cycles = 0;
      continue;
    }
    bool rejoined = false;
    for (int attempt = 0;
         attempt < node->cfg.max_rejoin_attempts && !node->closing; attempt++) {
      // exponential backoff with +/-50% jitter: orphaned siblings of a dead
      // interior node all start this loop at the same instant; jitter
      // de-synchronizes their walks (and their master-failover bind races)
      std::this_thread::sleep_for(std::chrono::duration<double>(
          node->cfg.rejoin_backoff_sec * (double)(1 << std::min(attempt, 6)) *
          (0.5 + frand64(&node->jrng))));
      bool became_master = false;
      sockaddr_in local{};
      int granted = 1;
      uint64_t token = 0;
      sockaddr_in final_t{};
      int fd = join_walk(node, node->rendezvous, /*allow_master=*/false,
                         &became_master, &local, &granted, &token, &final_t);
      if (fd >= 0) {
        // the new parent redirects joiners to `local`, the endpoint it
        // accepted, as the first join's parent does: listen there (before
        // the link is up, so no redirect can find it unbound)
        relisten(node, local);
        auto l = make_link(node, fd, /*is_uplink=*/1, nullptr, granted);
        if (granted > 1) open_stripes(node, l, final_t, token, granted);
        rejoined = true;
        break;
      }
    }
    if (rejoined || node->closing) {
      failed_cycles = 0;
      continue;
    }
    // Nobody to join: claim the rendezvous (master failover).
    int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (lfd >= 0) {
      set_common_sockopts(lfd);
      sockaddr_in rv = node->rendezvous;
      if (::bind(lfd, (sockaddr*)&rv, sizeof rv) == 0 &&
          ::listen(lfd, node->cfg.listen_backlog) == 0) {
        // Publish under mu with a closing re-check: st_node_close reads
        // rendezvous_listen_fd under the same lock AFTER setting closing,
        // so either we see closing here (and close lfd ourselves) or
        // close() sees the published fd — a bound rendezvous socket can
        // never leak past shutdown.
        bool published = false;
        {
          StLockGuard lk(node->mu);
          if (!node->closing) {
            node->is_master = true;
            node->rendezvous_listen_fd = lfd;
            published = true;
          }
        }
        if (!published) {
          ::close(lfd);
          break;
        }
        node->active_threads += 1;
        std::thread(listener_loop, node, lfd).detach();
        node->emit(3, 0, 0);  // became master: Python flips its role
        failed_cycles = 0;
        continue;
      }
      ::close(lfd);  // EADDRINUSE: a sibling won the race (or foreign IP)
    }
    if (++failed_cycles >= 2) {
      node->emit(4, 0, 1);  // isolated: cannot join OR claim the rendezvous
      failed_cycles = 0;    // keep trying, but don't spam the event
    }
  }
  --node->active_threads;
}

}  // namespace

// ---- C ABI ---------------------------------------------------------------

extern "C" {

typedef struct StNodeHandle StNodeHandle;

struct StConfigC {
  int32_t wire_compat;
  int32_t compat_frame_bytes;
  int32_t listen_backlog;
  int64_t bandwidth_cap_bps;
  double peer_timeout_sec;
  double keepalive_sec;
  int32_t max_children;
  int32_t queue_depth;
  int32_t max_rejoin_attempts;
  double rejoin_backoff_sec;
  double connect_timeout_sec;  // per-hop connect/reply bound (0 = blocking)
  double join_timeout_sec;     // total create-time join budget (0 = 30 s)
  int32_t stripe_count;        // r11: sockets per logical link (1..8)
  int32_t rcvbuf_bytes;        // SO_RCVBUF before connect (0 = autotuned)
};

struct StEventC {
  int32_t kind;
  int32_t link_id;
  int32_t is_uplink;
};

struct StStatsC {
  uint64_t bytes_out, bytes_in, frames_out, frames_in;
  int32_t send_queue, recv_queue;
};

// Create a node and join the tree at host:port (or become master when nobody
// answers). Returns NULL on error. is_master receives 1/0.
void* st_node_create(const char* host, int port, const StConfigC* cfg_c,
                     int32_t* is_master) {
  if (cfg_c->wire_compat && cfg_c->compat_frame_bytes < 5) {
    return nullptr;  // compat frames are [f32 scale][>=1 bitmask byte]
  }
  auto* node = new Node();
  node->obs_id =
      stobs::g_node_id_base |
      ((0xFFFu -
        stobs::g_next_node_local.fetch_add(1, std::memory_order_relaxed)) &
       0xFFFu);
  Config& cfg = node->cfg;
  cfg.wire_compat = cfg_c->wire_compat;
  cfg.compat_frame_bytes = cfg_c->compat_frame_bytes;
  cfg.listen_backlog = cfg_c->listen_backlog;
  cfg.bandwidth_cap_bps = cfg_c->bandwidth_cap_bps;
  cfg.peer_timeout_sec = cfg_c->peer_timeout_sec;
  cfg.keepalive_sec = cfg_c->keepalive_sec;
  cfg.max_children = std::min<int32_t>(cfg_c->max_children, 16);
  cfg.queue_depth = cfg_c->queue_depth;
  cfg.max_rejoin_attempts = cfg_c->max_rejoin_attempts;
  cfg.rejoin_backoff_sec = cfg_c->rejoin_backoff_sec;
  cfg.connect_timeout_sec = cfg_c->connect_timeout_sec;
  cfg.join_timeout_sec = cfg_c->join_timeout_sec;
  // striping is native-framing only (the reference compat protocol has
  // one stream per link by definition)
  cfg.stripe_count = cfg_c->stripe_count < 1
                         ? 1
                         : (cfg_c->stripe_count > kMaxStripes
                                ? kMaxStripes
                                : cfg_c->stripe_count);
  if (cfg.wire_compat) cfg.stripe_count = 1;
  cfg.rcvbuf_bytes = cfg_c->rcvbuf_bytes;
  cfg.fault = parse_fault_plan();  // env hook table, per-node at create
  node->jrng = (uint64_t)::getpid() * 0x9e3779b97f4a7c15ull +
               (uint64_t)Clock::now().time_since_epoch().count();
  {
    // no thread exists yet; the lock is for the analysis' benefit (and
    // costs one uncontended acquisition at create)
    StLockGuard lk(node->mu);
    node->token_rng = node->jrng ^ 0xA5A5A5A5DEADBEEFull;
  }

  hostent* server = gethostbyname(host);
  if (!server) {
    node->last_error = "no such host";
    delete node;
    return nullptr;
  }
  sockaddr_in target{};
  target.sin_family = AF_INET;
  memcpy(&target.sin_addr.s_addr, server->h_addr, server->h_length);
  target.sin_port = htons((uint16_t)port);
  node->rendezvous = target;

  // Join-or-become-master, with retry. Two races both end in a failed
  // first pass and both resolve by retrying as a joiner (the reference
  // inherits the same race and just dies, src/sharedtensor.c:271-277,314):
  //  - A and B start together; both find the rendezvous empty, both elect
  //    themselves master; one loses the bind (EADDRINUSE) — the loser must
  //    re-walk, and will now connect to the winner.
  //  - A joins while B (the would-be master) is between its failed connect
  //    and its listen(): A's walk fails outright; a short backoff later the
  //    master is listening.
  bool became_master = false;
  int up_fd = -1;
  int listen_fd = -1;
  int up_granted = 1;
  uint64_t up_token = 0;
  sockaddr_in up_final{};
  // Bounded join-or-become-master: a TOTAL deadline (join_timeout_sec)
  // replaces the old fixed 50-attempt loop, and retries back off
  // exponentially with +/-50% jitter — a herd of simultaneous joiners (or
  // the two election races above) must not re-collide in lockstep. Before
  // r06, an unreachable-but-not-refusing rendezvous hung the first
  // connect() forever; now every hop is bounded (connect_with_timeout)
  // and the whole loop gives up at the deadline, surfacing a
  // ConnectionError to Python instead of a wedged constructor.
  double budget = cfg.join_timeout_sec > 0 ? cfg.join_timeout_sec : 30.0;
  auto deadline = Clock::now() + std::chrono::duration<double>(budget);
  uint64_t jrng = node->jrng;
  for (int attempt = 0; attempt < 1000 && !listen_fd_ok(listen_fd);
       attempt++) {
    if (attempt > 0) {
      if (Clock::now() >= deadline) break;
      double base = 0.01 * (double)(1 << std::min(attempt - 1, 7));
      if (base > 2.0) base = 2.0;
      double sleep_s = base * (0.5 + frand64(&jrng));
      double rem =
          std::chrono::duration<double>(deadline - Clock::now()).count();
      if (sleep_s > rem) sleep_s = rem > 0 ? rem : 0;
      std::this_thread::sleep_for(std::chrono::duration<double>(sleep_s));
    }
    became_master = false;
    sockaddr_in listen_addr{};
    up_fd = join_walk(node, target, /*allow_master=*/true, &became_master,
                      &listen_addr, &up_granted, &up_token, &up_final);
    if (up_fd < 0 && !became_master) continue;  // tree settling; retry
    if (became_master) listen_addr = target;  // master owns the rendezvous addr

    // Bind the listen socket to the same endpoint our parent observed (the
    // reference's addressing trick) so redirects that hand out our accept()-
    // observed address reach our listener.
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    set_common_sockopts(listen_fd);
    if (::bind(listen_fd, (sockaddr*)&listen_addr, sizeof listen_addr) < 0 ||
        ::listen(listen_fd, cfg.listen_backlog) < 0) {
      // lost the master election (or our observed endpoint got reused):
      // close everything and re-walk as a joiner
      ::close(listen_fd);
      listen_fd = -1;
      if (up_fd >= 0) {
        ::close(up_fd);
        up_fd = -1;
      }
      continue;
    }
  }
  if (!listen_fd_ok(listen_fd)) {
    if (up_fd >= 0) ::close(up_fd);
    delete node;
    return nullptr;
  }
  {
    StLockGuard lk(node->mu);  // pre-thread, for the analysis (see above)
    node->is_master = became_master;
  }
  node->listen_fd = listen_fd;

  node->active_threads += 2;
  std::thread(listener_loop, node, listen_fd).detach();
  std::thread(rejoin_loop, node).detach();
  if (up_fd >= 0) {
    auto l = make_link(node, up_fd, /*is_uplink=*/1, nullptr, up_granted);
    if (up_granted > 1) open_stripes(node, l, up_final, up_token, up_granted);
  }
  if (is_master) *is_master = became_master ? 1 : 0;
  if (became_master) node->emit(3, 0, 0);
  return node;
}

// The node's process-unique obs id (tags its events on the shared rings).
uint32_t st_node_obs_id(void* h) {
  auto* node = (Node*)h;
  return node ? node->obs_id : 0;
}

int32_t st_node_listen_port(void* h) {
  auto* node = (Node*)h;
  sockaddr_in addr{};
  socklen_t len = sizeof addr;
  if (getsockname(node->listen_fd, (sockaddr*)&addr, &len) < 0) return -1;
  return (int32_t)ntohs(addr.sin_port);
}

// Enqueue a frame for a link. Returns 1 on success, 0 if the queue stayed
// full for timeout_sec (backpressure — caller should retry), -1 dead link.
int32_t st_node_send(void* h, int32_t link_id, const uint8_t* data,
                     int32_t len, double timeout_sec) {
  auto* node = (Node*)h;
  // Compat payload contract: K >= 1 whole reference frames, exactly
  // K * compat_frame_bytes. The sender loop's frames_out accounting
  // divides by compat_frame_bytes (integer), and the receiver re-frames
  // the stream in fixed-size chunks — a non-multiple payload would both
  // undercount silently and shear every later frame boundary on the
  // receiver, so reject it at the enqueue boundary.
  if (node->cfg.wire_compat && node->cfg.compat_frame_bytes > 0 &&
      (len <= 0 || len % node->cfg.compat_frame_bytes != 0))
    return -1;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  if (!link->alive) return -1;
  // ONE copy at the ABI boundary, into a recycled buffer (the bytes must
  // outlive the caller's, e.g. a Python bytes object, until the socket
  // write) — the old path allocated a fresh vector per message
  bool hit = false;
  OutMsg msg;
  msg.owned = link->tx_pool.get(&hit);
  node->tx_acquires++;
  if (!hit) node->tx_pool_misses++;
  msg.owned.assign(data, data + len);
  Link* lp = link.get();
  if (link->sendq.push_hook(std::move(msg), timeout_sec, [lp](OutMsg& m) {
        // stripe-seq stamp, under the queue mutex at insertion (r11): a
        // stamped seq is always eventually written, so reassembly never
        // waits on a hole
        m.sseq = lp->sseq_next.fetch_add(1, std::memory_order_relaxed);
      }))
    return 1;
  return 0;
}

// Zero-copy enqueue (the native engine's tx-ring path): the transport
// borrows [data, data+len) — NO copy is made — and calls release(ctx)
// exactly once when the bytes have left the socket (or the link died with
// the message queued; teardown releases via OutMsg's destructor). Returns
// 1 = enqueued (transport now owns one reference), 0 = backpressure and
// -1 = dead link (in both of which the transport took NO ownership and
// will never call release — the caller retains its reference).
int32_t st_node_send_zc(void* h, int32_t link_id, const uint8_t* data,
                        int32_t len, double timeout_sec,
                        void (*release)(void*), void* ctx) {
  auto* node = (Node*)h;
  if (node->cfg.wire_compat) return -1;  // compat framing has no zc path
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  if (!link->alive) return -1;
  OutMsg msg;
  msg.zdata = data;
  msg.zlen = (uint32_t)len;
  msg.release = release;
  msg.ctx = ctx;
  Link* lp = link.get();
  if (link->sendq.push_hook(std::move(msg), timeout_sec, [lp](OutMsg& m) {
        m.sseq = lp->sseq_next.fetch_add(1, std::memory_order_relaxed);
      })) {
    node->zc_msgs++;
    return 1;
  }
  // not enqueued: disarm before msg destructs — ownership stays with the
  // caller on every non-1 return
  msg.release = nullptr;
  return link->alive ? 0 : -1;
}

// Dequeue a received frame. Returns payload length (copied into buf up to
// cap), 0 if none within timeout, -1 if the link is dead AND drained.
int32_t st_node_recv(void* h, int32_t link_id, uint8_t* buf, int32_t cap,
                     double timeout_sec) {
  auto* node = (Node*)h;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  std::vector<uint8_t> frame;
  if (!link->recvq.pop(&frame, timeout_sec)) {
    return link->alive ? 0 : -1;
  }
  int32_t n = (int32_t)std::min<size_t>(frame.size(), (size_t)cap);
  memcpy(buf, frame.data(), (size_t)n);
  link->rx_pool.put(std::move(frame));  // recycle, capacity warm
  return n;
}

// Zero-copy receive (r14): like st_node_recv, but instead of copying into
// the caller's buffer the popped rx buffer is LOANED — *out points at its
// bytes and the return value is its length. The pointer stays valid until
// the next st_node_recv_zc / st_node_recv_done on the same link (loans
// live on the NODE, so a link torn down mid-parse cannot free them).
// Exactly one loan per link; the native engine's receiver is the intended
// caller (one message in hand at a time per link).
int32_t st_node_recv_zc(void* h, int32_t link_id, const uint8_t** out,
                        double timeout_sec) {
  auto* node = (Node*)h;
  *out = nullptr;
  std::vector<uint8_t> prev;
  {
    StLockGuard lk(node->loan_mu);
    auto it = node->loans.find(link_id);
    if (it != node->loans.end()) {
      prev = std::move(it->second);
      node->loans.erase(it);
    }
  }
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it != node->links.end()) link = it->second;
  }
  if (prev.capacity() && link) link->rx_pool.put(std::move(prev));
  if (!link) return -1;
  std::vector<uint8_t> frame;
  if (!link->recvq.pop(&frame, timeout_sec)) {
    return link->alive ? 0 : -1;
  }
  int32_t n = (int32_t)frame.size();
  {
    StLockGuard lk(node->loan_mu);
    auto& slot = node->loans[link_id];
    slot = std::move(frame);
    *out = slot.data();
  }
  return n;
}

// Release a link's outstanding recv_zc loan (recycling its buffer when
// the link still exists). Call when done draining a link; harmless when
// no loan is out.
void st_node_recv_done(void* h, int32_t link_id) {
  auto* node = (Node*)h;
  if (!node) return;
  std::vector<uint8_t> prev;
  {
    StLockGuard lk(node->loan_mu);
    auto it = node->loans.find(link_id);
    if (it != node->loans.end()) {
      prev = std::move(it->second);
      node->loans.erase(it);
    }
  }
  if (!prev.capacity()) return;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it != node->links.end()) link = it->second;
  }
  if (link) link->rx_pool.put(std::move(prev));
}

// r17 engine-tier shard plane: ownership-transfer receive, the transport
// half of the zero-copy verbatim relay. Like st_node_recv_zc, but the
// popped rx buffer's OWNERSHIP moves to the caller: *out points at its
// bytes, *tok receives an opaque owner token the caller releases with
// st_node_take_free(h, link_id, tok) exactly once (recycling the buffer
// into the link's rx pool when the link still exists, so the steady
// state stays allocation-free). The shard plane's relay path is the
// intended caller: a FWD frame whose owner is downstream is re-stamped
// IN PLACE (per-link seq only — the bytes are never decoded) and
// enqueued via st_node_send_zc straight from this same buffer, held
// through go-back-N retention — which makes relays ordinary zero-copy
// sends, eligible for sendmmsg batching and the r14 shm lane like any
// slot-backed message. No loan bookkeeping: the token outlives any
// number of recv calls on the link.
int32_t st_node_recv_take(void* h, int32_t link_id, const uint8_t** out,
                          void** tok) {
  auto* node = (Node*)h;
  *out = nullptr;
  *tok = nullptr;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it != node->links.end()) link = it->second;
  }
  if (!link) return -1;
  std::vector<uint8_t> frame;
  if (!link->recvq.pop(&frame, 0.0)) {
    return link->alive ? 0 : -1;
  }
  auto* owner = new std::vector<uint8_t>(std::move(frame));
  *out = owner->data();
  *tok = owner;
  return (int32_t)owner->size();
}

// Release a buffer taken with st_node_recv_take (exactly once). The link
// id routes the recycle back into the owning link's rx pool; a link torn
// down in the meantime just frees the buffer.
void st_node_take_free(void* h, int32_t link_id, void* tok) {
  auto* owner = (std::vector<uint8_t>*)tok;
  if (!owner) return;
  auto* node = (Node*)h;
  std::shared_ptr<Link> link;
  if (node) {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it != node->links.end()) link = it->second;
  }
  if (link) link->rx_pool.put(std::move(*owner));
  delete owner;
}

// Free slots in the link's send queue (-1 unknown link). The shard
// plane's outbox pump keeps control-traffic headroom with this — the
// python tier's _queue_room discipline: a data pump that races the
// cumulative ACKs and shard control messages for the last sendq slot
// starves the very ACKs that drain its own ledger.
int32_t st_node_sendq_room(void* h, int32_t link_id) {
  auto* node = (Node*)h;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  int32_t depth = node->cfg.queue_depth;
  int32_t used = (int32_t)link->sendq.size();
  return used >= depth ? 0 : depth - used;
}

// r07 pool/zero-copy observability:
// out[0..1] tx buffer acquires / misses (fresh allocations),
// out[2..3] rx buffer acquires / misses, out[4] zero-copy sends enqueued.
// Steady state must show acquires growing while misses stay flat — the
// "zero per-message heap allocations" assertion peer.metrics() surfaces.
void st_node_pool_stats(void* h, uint64_t* out5) {
  auto* node = (Node*)h;
  if (!node) {
    for (int i = 0; i < 5; i++) out5[i] = 0;
    return;
  }
  out5[0] = node->tx_acquires.load();
  out5[1] = node->tx_pool_misses.load();
  out5[2] = node->rx_acquires.load();
  out5[3] = node->rx_pool_misses.load();
  out5[4] = node->zc_msgs.load();
}

// r11 per-link stripe telemetry: out4[0] = negotiated stripe count,
// out4[1] = live stripes, out4[2] = stripe deaths on this link,
// out4[3] = messages re-routed off a dying stripe. Returns -1 for an
// unknown link.
// Bound what the sending side of a link holds in flight: each sender
// thread takes one message at a time from sendq (no batch of up to
// kCoalesce, which a producer that keeps sendq short refills while the
// batch gathers), and the kernel send buffer of each live socket is capped
// at `bytes` (SO_SNDBUF, which the kernel doubles for its bookkeeping and
// stops autotuning), so a blocking write waits for the peer to read. The
// writer of a read-only subscriber link calls it once the link is
// attached. Each stripe's fd is held open for the call as its I/O threads
// hold it (stripe_io), so a dying stripe's fd is never closed under it.
// Returns the count of sockets capped, or -1 for an unknown link.
int32_t st_node_cap_inflight(void* h, int32_t link_id, int32_t bytes) {
  auto* node = (Node*)h;
  if (!node || bytes <= 0) return -1;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  link->batch_max.store(1, std::memory_order_relaxed);
  int32_t capped = 0;
  for (int i = 0; i < link->nstripes; i++) {
    int io = link->stripe_io[i].load();
    while (io > 0 && !link->stripe_io[i].compare_exchange_weak(io, io + 1)) {
    }
    if (io <= 0) continue;  // never attached, or its threads have exited
    int v = bytes;
    if (link->stripe_ok[i].load() &&
        setsockopt(link->stripe_fd[i], SOL_SOCKET, SO_SNDBUF, &v, sizeof v) ==
            0)
      capped++;
    if (--link->stripe_io[i] == 0) ::close(link->stripe_fd[i]);
  }
  return capped;
}

int32_t st_node_stripe_stats(void* h, int32_t link_id, uint64_t* out4) {
  auto* node = (Node*)h;
  for (int i = 0; i < 4; i++) out4[i] = 0;
  if (!node) return -1;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  out4[0] = (uint64_t)link->nstripes;
  out4[1] = (uint64_t)(link->stripes_live.load() < 0
                           ? 0
                           : link->stripes_live.load());
  out4[2] = link->stripe_deaths.load();
  out4[3] = link->reroutes.load();
  return 0;
}

// ---- r14 same-host shm lane ABI ------------------------------------------

// CREATE the link's shm segment (the parent's half of the negotiated
// attach): a /dev/shm file holding one header page + two rings of
// ring_bytes each. Writes the segment basename into name_out and the
// validation token into token_out; the peer passes both to
// st_node_shm_join. The data plane switches lanes only once the joiner
// has mapped and validated (Hdr::joined) — until then, and forever on
// failure, the link keeps streaming on TCP. Returns 0, or -1 (bad
// link/mode/state) / -2 (segment creation failed).
int32_t st_node_shm_serve(void* h, int32_t link_id, int64_t ring_bytes,
                          char* name_out, int32_t name_cap,
                          uint64_t* token_out) {
  auto* node = (Node*)h;
  if (!node || node->cfg.wire_compat) return -1;
  // a PER-STRIPE fault plan (only_stripe >= 0) is a TCP-striping
  // diagnostic — the lane's single-writer data plane would mask it, so
  // the chaos arm pins the link to TCP (link-wide fault classes apply on
  // the lane writer and stay fully covered)
  if (node->cfg.fault.enabled && node->cfg.fault.only_stripe >= 0)
    return -1;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it != node->links.end()) link = it->second;
  }
  if (!link || !link->alive ||
      link->shm.load(std::memory_order_acquire) != nullptr)
    return -1;
  if (ring_bytes < (1 << 16)) ring_bytes = 1 << 16;
  if (ring_bytes > (1 << 30)) ring_bytes = 1 << 30;
  ring_bytes = (ring_bytes + 4095) & ~(int64_t)4095;

  uint64_t tok;
  {
    StLockGuard lk(node->mu);
    node->token_rng ^=
        ((uint64_t)link_id << 32) * 0x9e3779b97f4a7c15ull + (uint64_t)getpid();
    frand64(&node->token_rng);
    tok = node->token_rng;
  }
  char name[96];
  snprintf(name, sizeof name, "stshm-%d-%d-%016llx", (int)getpid(),
           (int)link_id, (unsigned long long)tok);
  if ((int32_t)strlen(name) + 1 > name_cap) return -1;
  std::string path = std::string("/dev/shm/") + name;
  int fd = ::open(path.c_str(), O_RDWR | O_CREAT | O_EXCL | O_CLOEXEC, 0600);
  if (fd < 0) return -2;
  size_t map_len = stshm::kDataOff + 2 * (size_t)ring_bytes;
  if (::ftruncate(fd, (off_t)map_len) != 0) {
    ::close(fd);
    ::unlink(path.c_str());
    return -2;
  }
  void* base =
      ::mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) {
    ::unlink(path.c_str());
    return -2;
  }
  auto* hd = new (base) stshm::Hdr();  // placement-init the atomics
  hd->magic = stshm::kMagic;
  hd->version = stshm::kVersion;
  hd->ring_bytes = (uint32_t)ring_bytes;
  hd->token = tok;

  auto* lane = new stshm::Lane();
  lane->hdr = hd;
  lane->data[0] = (uint8_t*)base + stshm::kDataOff;
  lane->data[1] = (uint8_t*)base + stshm::kDataOff + (size_t)ring_bytes;
  lane->map_len = map_len;
  lane->ring_bytes = (uint32_t)ring_bytes;
  lane->creator = 1;
  lane->name = name;
  // striped links reassemble by stripe seq, so ring delivery may start
  // immediately; unstriped delivery waits for the in-stream SWITCH marker
  lane->rx_go.store(link->nstripes > 1, std::memory_order_release);
  link->shm.store(lane, std::memory_order_release);
  node->active_threads += 1;
  std::thread(shm_rx_loop, node, link).detach();
  snprintf(name_out, (size_t)name_cap, "%s", name);
  if (token_out) *token_out = tok;
  return 0;
}

// JOIN the peer's shm segment by name+token (the child's half). On
// success the segment name is immediately unlinked (it cannot outlive the
// two mappings), Hdr::joined flips the creator's tx lane live, and this
// side's tx activates at its sender's next pop. On ANY failure the link
// keeps TCP and a shm_fallback event records why (arg: 1 open, 2 map,
// 3 header/token mismatch).
int32_t st_node_shm_join(void* h, int32_t link_id, const char* name,
                         uint64_t token) {
  auto* node = (Node*)h;
  if (!node || node->cfg.wire_compat || !name) return -1;
  // per-stripe chaos pins TCP on the joining side too (see shm_serve)
  if (node->cfg.fault.enabled && node->cfg.fault.only_stripe >= 0)
    return -1;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it != node->links.end()) link = it->second;
  }
  if (!link || !link->alive ||
      link->shm.load(std::memory_order_acquire) != nullptr)
    return -1;
  // the name is peer-supplied: confine it to our own flat namespace
  if (strncmp(name, "stshm-", 6) != 0 || strchr(name, '/') != nullptr ||
      strstr(name, "..") != nullptr || strlen(name) > 80) {
    st_obs_emit(node->obs_id, stobs::kEvShmFallback, link_id, 3);
    return -3;
  }
  std::string path = std::string("/dev/shm/") + name;
  int fd = ::open(path.c_str(), O_RDWR | O_CLOEXEC);
  if (fd < 0) {
    st_obs_emit(node->obs_id, stobs::kEvShmFallback, link_id, 1);
    return -1;
  }
  struct stat st;
  if (::fstat(fd, &st) != 0 ||
      (size_t)st.st_size < stshm::kDataOff + 2 * (1 << 16)) {
    ::close(fd);
    st_obs_emit(node->obs_id, stobs::kEvShmFallback, link_id, 2);
    return -2;
  }
  size_t map_len = (size_t)st.st_size;
  void* base =
      ::mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) {
    st_obs_emit(node->obs_id, stobs::kEvShmFallback, link_id, 2);
    return -2;
  }
  auto* hd = (stshm::Hdr*)base;
  if (hd->magic != stshm::kMagic || hd->version != stshm::kVersion ||
      hd->token != token ||
      stshm::kDataOff + 2 * (size_t)hd->ring_bytes != map_len) {
    ::munmap(base, map_len);
    st_obs_emit(node->obs_id, stobs::kEvShmFallback, link_id, 3);
    return -3;
  }
  ::unlink(path.c_str());  // leak-proof: the name dies with this map

  auto* lane = new stshm::Lane();
  lane->hdr = hd;
  lane->data[0] = (uint8_t*)base + stshm::kDataOff;
  lane->data[1] = (uint8_t*)base + stshm::kDataOff + hd->ring_bytes;
  lane->map_len = map_len;
  lane->ring_bytes = hd->ring_bytes;
  lane->creator = 0;
  lane->rx_go.store(link->nstripes > 1, std::memory_order_release);
  link->shm.store(lane, std::memory_order_release);
  node->active_threads += 1;
  std::thread(shm_rx_loop, node, link).detach();
  // publish LAST: the creator's senders switch lanes on observing this
  hd->joined.store(1, std::memory_order_release);
  stshm::futex_wake_all(&hd->ring[0].head_seq);
  return 0;
}

// r14 shm lane telemetry: out8[0] = lane state (0 = TCP only, 1 = segment
// mapped, 2 = tx live), [1..2] = messages out/in over the lane, [3..4] =
// lane bytes out/in (record headers included), [5] = ring bytes per
// direction, [6..7] = tx/rx futex sleeps (the spin-before-sleep misses).
// Returns -1 for an unknown link.
int32_t st_node_shm_stats(void* h, int32_t link_id, uint64_t* out8) {
  auto* node = (Node*)h;
  for (int i = 0; i < 8; i++) out8[i] = 0;
  if (!node) return -1;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  stshm::Lane* sl = link->shm.load(std::memory_order_acquire);
  if (!sl) return 0;
  out8[0] = sl->tx_ready() ? 2 : 1;
  out8[1] = sl->msgs_out.load();
  out8[2] = sl->msgs_in.load();
  out8[3] = sl->bytes_out.load();
  out8[4] = sl->bytes_in.load();
  out8[5] = (uint64_t)sl->ring_bytes;
  out8[6] = sl->tx_waits.load();
  out8[7] = sl->rx_waits.load();
  return 0;
}

int32_t st_node_poll_events(void* h, StEventC* out, int32_t cap,
                            double timeout_sec) {
  auto* node = (Node*)h;
  StUniqueLock lk(node->ev_mu);
  if (node->events.empty() && timeout_sec > 0) {
    node->ev_cv.wait_until(lk.native(), st_cv_deadline(timeout_sec));
  }
  int32_t n = 0;
  while (n < cap && !node->events.empty()) {
    Event e = node->events.front();
    node->events.pop_front();
    out[n].kind = e.kind;
    out[n].link_id = e.link_id;
    out[n].is_uplink = e.is_uplink;
    n++;
  }
  return n;
}

int32_t st_node_links(void* h, int32_t* out, int32_t cap) {
  auto* node = (Node*)h;
  StLockGuard lk(node->mu);
  int32_t n = 0;
  for (auto& kv : node->links) {
    if (n >= cap) break;
    out[n++] = kv.first;
  }
  return n;
}

int32_t st_node_uplink(void* h) {
  auto* node = (Node*)h;
  StLockGuard lk(node->mu);
  return node->uplink_id;
}

int32_t st_node_stats(void* h, int32_t link_id, StStatsC* out) {
  auto* node = (Node*)h;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  out->bytes_out = link->bytes_out;
  out->bytes_in = link->bytes_in;
  out->frames_out = link->frames_out;
  out->frames_in = link->frames_in;
  out->send_queue = (int32_t)link->sendq.size();
  out->recv_queue = (int32_t)link->recvq.size();
  return 0;
}

// Data-arrival sequence number: bumps whenever any link delivers a frame
// into its recv queue (or a link dies). Pair with st_node_wait_data for
// blocking multi-link consumption without per-queue polling.
uint64_t st_node_data_seq(void* h) {
  auto* node = (Node*)h;
  StLockGuard lk(node->data_mu);
  return node->data_seq;
}

// Block until the data sequence advances past last_seq (returns the new
// value), or timeout (returns the current value). A caller that drains the
// queues, then waits on the seq it read BEFORE draining, can never miss a
// wakeup.
uint64_t st_node_wait_data(void* h, uint64_t last_seq, double timeout_sec) {
  auto* node = (Node*)h;
  StUniqueLock lk(node->data_mu);
  if (timeout_sec > 0) {
    // explicit deadline loop (not wait_for-with-predicate): the predicate
    // lambda would read the guarded data_seq from a context the
    // thread-safety analysis treats as lock-free
    const auto deadline = st_cv_deadline(timeout_sec);
    while (node->data_seq <= last_seq &&
           node->data_cv.wait_until(lk.native(), deadline) !=
               std::cv_status::timeout) {
    }
  }
  return node->data_seq;
}

// Drop one link deliberately (tests / fault injection).
int32_t st_node_drop_link(void* h, int32_t link_id) {
  auto* node = (Node*)h;
  std::shared_ptr<Link> link;
  {
    StLockGuard lk(node->mu);
    auto it = node->links.find(link_id);
    if (it == node->links.end()) return -1;
    link = it->second;
  }
  kill_link(node, link);
  return 0;
}

void st_node_close(void* h) {
  auto* node = (Node*)h;
  node->closing = true;
  ::shutdown(node->listen_fd, SHUT_RDWR);
  ::close(node->listen_fd);
  int rg_fd, rv_fd;
  {
    StLockGuard lk(node->mu);
    rg_fd = node->regraft_listen_fd;
    rv_fd = node->rendezvous_listen_fd;
  }
  if (rg_fd >= 0) {
    ::shutdown(rg_fd, SHUT_RDWR);
    ::close(rg_fd);
  }
  if (rv_fd >= 0) {
    ::shutdown(rv_fd, SHUT_RDWR);
    ::close(rv_fd);
  }
  std::vector<std::shared_ptr<Link>> links;
  {
    StLockGuard lk(node->mu);
    for (auto& kv : node->links) links.push_back(kv.second);
  }
  for (auto& l : links) kill_link(node, l);
  node->ev_cv.notify_all();
  node->notify_data();  // unblock any engine waiting in st_node_wait_data
  // All threads are detached; wait (bounded) for them to drain.
  for (int i = 0; i < 1000 && node->active_threads > 0; i++) {
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  if (node->active_threads == 0) {
    delete node;
  }
  // else: leak the node rather than free memory under a live thread —
  // cannot happen unless a peer wedges a write for >10s during shutdown.
}

}  // extern "C"
