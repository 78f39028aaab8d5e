// stengine: the native steady-state link engine for host-tier peers.
//
// Round-3 measurement: the Python peer engine costs ~3 ms of interpreter
// work per wire message, capping small-table throughput at ~300 messages/s
// (~8.8 k frames/s at 4 Ki via 30-frame bursts) where the reference's bare
// C loop does 78 k frames/s (BASELINE.md; reference src/sharedtensor.c:
// 133-189 has no per-frame interpreter cost at all). This engine moves the
// whole steady-state cycle — scale/quantize (error feedback), wire encode,
// send, receive, decode, flood apply, ACK bookkeeping — into C, calling the
// same stcodec.c loops the numpy tier uses — bit-identical GIVEN the same
// scales; burst frames b >= 1 derive their scales from partials fused into
// the previous quantize pass (stc_quantize_ef_partials), whose summation
// order can differ from a standalone rescan by ~1 ulp, within the tier
// tolerance every scale consumer already accepts (scales ride the wire,
// receivers never recompute them) — and the sttransport.cpp queues
// directly. Python keeps only what is control-plane:
// join/SYNC handshakes, membership events, checkpoint, metrics.
//
// Semantics are a 1:1 port of the Python tier (comm/peer.py send/recv loops
// + core.SharedTensor), including:
//  - per-link residual error feedback with an unacked-message ledger;
//    rollback on link death restores undelivered frames bit-for-bit
//    (core.SharedTensor._unapply);
//  - cumulative per-message ACKs, counted even for undecodable DATA/BURST
//    (the sender's ledger pops per message — see comm/peer.py);
//  - split-horizon flood: an incoming frame applies to the replica and to
//    every OTHER link's residual (reference src/sharedtensor.c:124-127);
//  - BURST framing for small tables, DATA for large, non-finite scales
//    zeroed at the trust boundary, +/-3e38 saturation everywhere.
//
// Latency: the receiver BLOCKS on the transport's data-arrival condvar
// (st_node_wait_data) and the sender on an engine condvar poked by add(),
// attach and incoming floods — no polling floors (the Python tier's 2 ms
// recv sleep / 50 ms drain poll don't exist here).
//
// Locking mirrors the Python tier: ONE mutex over (values, residuals,
// ledgers); codec loops run under it; socket I/O outside it.

#include <unistd.h>

#include <cmath>

#include "st_annotations.h"  // clang -Wthread-safety vocabulary (no-op on gcc)
#include "st_cv.h"           // system-clock condvar deadlines (TSan arm)
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <utility>
#include <vector>

// ---- imported C APIs (same-directory .so's, linked with $ORIGIN rpath) ---

extern "C" {
// stcodec.c
void stc_quantize(const float*, float*, const int64_t*, const int64_t*,
                  const int64_t*, int64_t, const float*, uint32_t*);
void stc_quantize_ef_partials(const float*, float*, const int64_t*,
                              const int64_t*, const int64_t*, int64_t,
                              const float*, uint32_t*, double*, double*,
                              double*);
void stc_scale_partials(const float*, const int64_t*, const int64_t*, int64_t,
                        double*, double*, double*);
void stc_accumulate_delta(float*, const int64_t*, const int64_t*,
                          const int64_t*, int64_t, const float*,
                          const uint32_t*);
void stc_add_to(float*, const float*, const float*, int64_t);
void stc_apply_frame(const float*, float*, const int64_t*, const int64_t*,
                     const int64_t*, int64_t, const float*, const uint32_t*);
void stc_accumulate_update_to(float*, const float*, const float*,
                              const int64_t*, const int64_t*, const int64_t*,
                              int64_t);
void stc_accumulate_update_to_partials(float*, const float*, const float*,
                                       const int64_t*, const int64_t*,
                                       const int64_t*, int64_t, double*,
                                       double*, double*);
void stc_apply_frames(const float*, float*, const int64_t*, const int64_t*,
                      const int64_t*, int64_t, int64_t, int32_t, const float*,
                      const uint32_t*, double*, double*, double*);
// r11 cascade quantize (K halving frames in one pass) + sign2 (2-bit)
// kernels — see stcodec.c's r11 section for semantics and layout.
void stc_quantize_ef_cascade(const float*, float*, const int64_t*,
                             const int64_t*, const int64_t*, int64_t, int32_t,
                             const float*, uint32_t*, int64_t, double*,
                             double*, double*);
void stc_quantize2_ef_cascade(const float*, float*, const int64_t*,
                              const int64_t*, const int64_t*, int64_t,
                              int32_t, const float*, uint32_t*, int64_t,
                              int64_t, double*, double*, double*);
void stc_apply_frames2(const float*, float*, const int64_t*, const int64_t*,
                       const int64_t*, int64_t, int64_t, int32_t,
                       const float*, const uint32_t*, double*, double*,
                       double*);
// r14 wire-layout fused applies: read scales/words straight from the
// (4-aligned, v3-framed) wire body — no repack copy.
void stc_apply_frames_wire(const float*, float*, const int64_t*,
                           const int64_t*, const int64_t*, int64_t, int64_t,
                           int32_t, const uint8_t*, int64_t, double*,
                           double*, double*);
void stc_apply_frames2_wire(const float*, float*, const int64_t*,
                            const int64_t*, const int64_t*, int64_t, int64_t,
                            int32_t, const uint8_t*, int64_t, double*,
                            double*, double*);
void stc_apply_frame2(const float*, float*, const int64_t*, const int64_t*,
                      const int64_t*, int64_t, int64_t, const float*,
                      const uint32_t*);
// sttransport.cpp
int32_t st_node_send(void*, int32_t, const uint8_t*, int32_t, double);
// zero-copy enqueue: the transport borrows the payload (no copy) and calls
// release(ctx) exactly once after the socket write / at teardown; on a
// non-1 return it took no ownership (see sttransport.cpp st_node_send_zc)
int32_t st_node_send_zc(void*, int32_t, const uint8_t*, int32_t, double,
                        void (*)(void*), void*);
int32_t st_node_recv(void*, int32_t, uint8_t*, int32_t, double);
// r14 zero-copy receive: the transport LOANS the popped rx buffer (valid
// until the next recv_zc/recv_done on the same link) instead of copying
// it out — one full-message copy gone from the receive hot path, on every
// lane (TCP, striped, shm).
int32_t st_node_recv_zc(void*, int32_t, const uint8_t**, double);
void st_node_recv_done(void*, int32_t);
// r17 shard plane: ownership-transfer receive (the transport half of the
// zero-copy verbatim relay) + sendq headroom probe (the _queue_room
// discipline). See sttransport.cpp for semantics.
int32_t st_node_recv_take(void*, int32_t, const uint8_t**, void**);
void st_node_take_free(void*, int32_t, void*);
int32_t st_node_sendq_room(void*, int32_t);
int32_t st_node_drop_link(void*, int32_t);
uint64_t st_node_data_seq(void*);
uint64_t st_node_wait_data(void*, uint64_t, double);
// Fault-injection crash point (ST_FAULT_CRASH="point:N"; ONE parse/countdown
// for the whole .so, defined in sttransport.cpp — see its docstring). The
// engine's protocol points: "mid-burst" (frames quantized + ledgered,
// message NOT yet on the wire) and "between-apply-and-ack" (mass applied +
// flooded, ACK not yet sent — the two-generals at-least-once window).
// comm/faults.py documents the schedule format and renders FaultConfig
// into it (to_env).
void st_fault_crash_point(const char*);
// r08 obs event ring (defined once in sttransport.cpp; codes are ABI —
// obs/events.py CODE_NAMES is the authoritative mirror). Engine-side
// events: retransmit(10), black-hole teardown(11), quarantine(12),
// send-window stall(13, edge-triggered), dedup/gap discard(14), seal(15),
// trace-hop apply(30, r09 — emitted per accepted traced data message with
// (origin << 8 | hop) packed into the record's extra word).
void st_obs_emit(uint32_t node_id, uint32_t code, int32_t link, uint64_t arg);
void st_obs_emit2(uint32_t node_id, uint32_t code, int32_t link, uint64_t arg,
                  uint32_t extra);
uint64_t st_obs_now_ns();
int32_t st_obs_is_enabled();
uint32_t st_node_obs_id(void*);
}

namespace {

// wire message kinds (comm/wire.py)
constexpr uint8_t kData = 0;
constexpr uint8_t kAck = 6;
constexpr uint8_t kBurst = 7;
// r10 serving tier: FRESH = parent's drained-residual freshness mark for a
// subscriber link ([kind][u64 monotonic ns]); RDATA = one frame sliced to
// the subscribed word range ([kind][u32 seq][u32 word_lo][u32 word_cnt]
// [trace?][scales L*4][words word_cnt*4]). Both are emitted by this
// sender for subscriber-mode links only; neither is ever received here
// (subscribers run the Python serve tier).
constexpr uint8_t kFresh = 10;
constexpr uint8_t kRData = 11;

constexpr float kSat = 3.0e38f;

// Go-back-N send window / per-round retransmission prefix (comm/peer.py
// SEND_WINDOW / RETX_PREFIX — same bounds, same rationale: cap a stalled
// link's retained ledger memory, and re-send only the head that can
// actually restore in-order progress at the receiver).
constexpr size_t kSendWindow = 32;
constexpr size_t kRetxPrefix = 4;
// Frames per message on SUBSCRIBER links (r10), capping the writer-tier
// burst: a serving link trades batch efficiency for pipeline LATENCY —
// its staleness floor is (transport queue depth) x (per-message apply
// time at the python-tier subscriber), so 255-frame multi-MB bursts put
// the floor at seconds while 32 keeps it near the read bound. Writers'
// writer links keep the full burst (peer.py SEND_WINDOW rationale).
constexpr int kSubBurstCap = 32;

// scale policies (config.ScalePolicy)
enum Policy { kPow2Rms = 0, kRms = 1, kAbsMean = 2 };

// ---- tx slot ring (r07 zero-copy data plane) ------------------------------
//
// A TxSlot is one preallocated wire-message buffer shared by every stage
// that used to copy: the codec threads QUANTIZE DIRECTLY into it (scales +
// sign words land at their final wire offsets), the go-back-N ledger entry
// IS the slot (retransmission is trivially byte-identical — the bytes are
// never re-encoded), and the transport sends it zero-copy (st_node_send_zc
// + writev: length prefix and slot body gather in one syscall). The old
// path built msg vectors, encoded them into a payload vector, and
// st_node_send copied that again — three full-message copies plus a fresh
// multi-MB allocation per message, all gone.
//
// Layout: buf[8..] is the frame body (frame f's scales at f*per, words at
// f*per + 4L — per = 4L + 4W is a multiple of 4, so with the body
// 8-aligned every codec pointer the kernels receive is properly aligned;
// UBSan-clean). The wire header is packed immediately BEFORE the body:
// BURST [kind][u32 seq][u8 k] at offset 2, DATA [kind][u32 seq] at offset
// 3, so wire_off + header + body are contiguous without moving the body.
//
// Lifecycle is a refcount: the ledger holds one reference from encode
// until ACK/rollback; each in-flight transport enqueue (first send AND
// every retransmit) holds another, dropped by the transport's release
// callback after the socket write. SEND_WINDOW times out-of-order ACKs
// bound the live slots per link; the free list keeps a few buffers warm
// and frees the rest, so a burst's high-water mark doesn't pin memory.
struct TxPool;

struct TxSlot {
  std::vector<uint8_t> buf;
  uint32_t wire_off = 0, wire_len = 0;
  std::atomic<int32_t> refs{0};
  TxPool* pool = nullptr;
};

struct TxPool {
  StMutex mu;
  std::vector<TxSlot*> free_ ST_GUARDED_BY(mu);
  std::vector<std::unique_ptr<TxSlot>> all_ ST_GUARDED_BY(mu);
  // written between create and start only (st_engine_set_codec); the
  // sender thread reads it unlocked after the start fence
  size_t slot_bytes = 0;   // 8 + burst * frame_bytes
  size_t keep_warm = 4;    // free slots retained with their buffer intact
  size_t warm_ ST_GUARDED_BY(mu) = 0;  // free_ entries with buf intact
                                       // (all at the back)
  std::atomic<uint64_t> acquires{0}, alloc_events{0};

  TxSlot* acquire() {
    acquires++;
    TxSlot* s;
    {
      StLockGuard lk(mu);
      if (!free_.empty()) {
        s = free_.back();
        free_.pop_back();
        if (warm_ > 0 && !s->buf.empty()) warm_--;
      } else {
        all_.emplace_back(new TxSlot());
        s = all_.back().get();
        s->pool = this;
      }
    }
    if (s->buf.size() != slot_bytes) {
      alloc_events++;  // fresh slot, or re-grow after an idle shrink
      s->buf.resize(slot_bytes);
    }
    s->refs.store(1, std::memory_order_relaxed);  // the caller's reference
    return s;
  }

  void unref(TxSlot* s) {
    // the decrement happens UNDER the pool mutex: st_engine_destroy's
    // drain loop checks all refs under the same mutex, so it can never
    // observe "all drained" while a releaser sits between its decrement
    // and the free-list push (it would then free the pool under us)
    StLockGuard lk(mu);
    if (s->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      if (warm_ >= keep_warm) {
        // bound idle memory: keep the slot object, drop its buffer — and
        // park it at the COLD end of the list so acquire() (which pops
        // the back) keeps hitting the warm buffers. The bound counts
        // WARM free slots (warm_), not the free list's length: once a
        // window stall grew the pool, the list stays longer than
        // keep_warm forever even though most entries are cold, and a
        // length-based check then shrank every returning slot — each
        // steady-state message paid a multi-MB value-initializing
        // resize + page faults under the data-plane mutex (measured
        // ~1.7 ms of the 1 Mi sender's 3.3 ms pass wall).
        s->buf.clear();
        s->buf.shrink_to_fit();
        free_.insert(free_.begin(), s);
      } else {
        free_.push_back(s);
        warm_++;
      }
    }
  }
};

// transport release callback: one in-flight reference returned
void tx_slot_release(void* ctx) {
  auto* s = (TxSlot*)ctx;
  s->pool->unref(s);
}

// obs event codes the engine emits (mirror of sttransport.cpp stobs::kEv*)
constexpr uint32_t kEvRetransmit = 10;
constexpr uint32_t kEvBlackhole = 11;
constexpr uint32_t kEvQuarantine = 12;
constexpr uint32_t kEvWindowStall = 13;
constexpr uint32_t kEvDedupDiscard = 14;
constexpr uint32_t kEvSeal = 15;
constexpr uint32_t kEvTraceApply = 30;  // r09 cross-hop trace propagation
constexpr uint32_t kEvSubAttach = 31;   // r10 subscriber link attached
constexpr uint32_t kEvPrecShift = 32;   // r11 governor flipped link precision

// r11 adaptive precision: the kind byte's top bit marks a sign2 (2-bit)
// DATA/BURST message — body per frame is [scales L*4][sign W*4][mag W*4]
// instead of [scales][sign]. Receivers here tolerant-decode BOTH widths
// unconditionally (precision bit selects the frame size; message length
// still disambiguates the r09 v1/v2 trace framing within each width), and
// EMISSION is gated per link on the peer's advertised capability
// (compat.SYNC_FLAG_SIGN2 / WELCOME flags -> st_engine_link_allow_sign2),
// so mixed trees interop: a pre-r11 peer never advertises and never
// receives a 2-bit frame.
constexpr uint8_t kPrecBit = 0x80;

// ---- r09 trace context (comm/wire.py v2 framing) --------------------------
//
// DATA v2: [kind u8][seq u32][origin u32][origin_ns u64][hops u8][body]
// BURST v2: [kind u8][seq u32][k u8][origin u32][origin_ns u64][hops u8][body]
// The 13-byte trace context stamps each outgoing message with the causal
// provenance of the LATEST update folded into this node's residuals: a
// local add() re-seeds it (origin = this node, hops = 0); applying a
// traced foreign message advances it (origin/gen preserved, hops + 1).
// Receivers accept BOTH v1 (r08, 5/6-byte headers) and v2 sizes — per is a
// multiple of 4 and the trace adds 13, so message length disambiguates the
// version unambiguously and mixed-version trees interop (the version gate
// lives in compat.py / ObsConfig.trace_wire; SYNC advertises it).
constexpr size_t kTraceBytes = 13;
constexpr size_t kDataHdrV1 = 5, kBurstHdrV1 = 6;
constexpr size_t kDataHdrV2 = kDataHdrV1 + kTraceBytes;   // 18
constexpr size_t kBurstHdrV2 = kBurstHdrV1 + kTraceBytes;  // 19
// r14 "aligned" v3 framing — ONE 24-byte header for DATA and BURST:
// [kind u8][k u8][pad u16][seq u32][origin u32][gen u64][hops u8][pad*3].
// Sized so the frame body lands 8-ALIGNED in the receiver's buffer, which
// lets the fused apply read scales/words straight from the wire body
// (stc_apply_frames_wire) — the receive path's full-message repack (one
// read + one write of every wire byte) disappears. Emission is gated per
// link on the peer's advertised r14 capability (the SYNC/WELCOME shm
// flag doubles as the r14 marker — compat.py) AND on trace_wire (the
// trace context is a fixed field here); decode is unconditional and
// length-disambiguated from v1/v2 exactly like r09's bump: per is a
// multiple of 4, and 24 ≡ 0 (mod 4) collides with neither 5/18 (kData)
// nor 6/19 (kBurst). The trace context occupies bytes 8..20, the same
// contiguous [origin u32][gen u64][hops u8] order v2 carries.
constexpr size_t kHdrV3 = 24;
// Header room reserved before a tx slot's 8-aligned frame body (was 8 in
// r07; v2's largest header is 19 bytes, so the room grows to the next
// multiple of 8 — the body stays aligned for the codec kernels).
constexpr size_t kBodyOff = 24;

struct SentMsg {
  // one wire message = 1..k frames; rolls back / acks whole
  int32_t nframes;
  // frame precision (r11): 1 = sign-bit frames, 2 = sign2 (2-bit) frames —
  // rollback must re-apply each ledgered frame with the matching kernel
  uint8_t prec = 1;
  uint64_t seq = 0;      // per-link wire seq (comm/wire.py tx_seq)
  // ledger-append time: ACK-pop minus this is the delivery round trip the
  // r08 RTT counters aggregate (st_engine_counters[10..11]); includes any
  // retransmission rounds, which is what an operator debugging a slow link
  // wants the number to include
  std::chrono::steady_clock::time_point sent_at{};
  TxSlot* slot = nullptr;  // native framing: the encoded wire bytes
                           // (this ledger entry owns one pool reference)
  std::vector<float> scales;    // compat path only: nframes * L
  std::vector<uint32_t> words;  // compat path only: nframes * W
};

using EClock = std::chrono::steady_clock;

struct ELink {
  std::vector<float> resid;
  std::deque<SentMsg> unacked;
  // the ledger a teardown (send failure, black hole) rolled back, kept with
  // its slot references until Python stashes the link (a severed uplink's
  // record, Engine::kept) or detaches it
  std::deque<SentMsg> rolled;
  uint64_t acked_cum = 0;  // cumulative ACK count received from the peer
  uint64_t tx_seq = 0;     // wire seq of the last DATA/BURST sent
  // last IN-ORDER wire seq accepted from the peer (== cumulative accepted
  // messages; comm/wire.py tx_seq discipline). Doubles as the ACK value.
  uint64_t rx_count = 0;
  uint64_t ack_sent = 0;   // highest ACK value actually delivered
  // go-back-N delivery timer (Engine::ack_timeout): time of the link's
  // last delivery progress, and fruitless retransmission rounds since
  EClock::time_point ack_progress{};
  int32_t retx_rounds = 0;
  // edge detector for the send-window stall event (kEvWindowStall): emit
  // once per blocked episode, not once per sender pass (a stalled link
  // would otherwise spam the ring at wake frequency)
  bool window_blocked = false;
  bool dirty = true;       // residual may quantize to something nonzero
  bool dead = false;       // transport reported death; stop touching
  // Scale-partials cache for this residual: every pass that already walks
  // the residual (quantize, flood apply, add) refreshes it fused, so the
  // sender's standalone stc_scale_partials scan — a full-table read per
  // message, 1/3 of sender traffic at 16 Mi — only runs after the rare
  // writes that bypass the fused kernels (rollback, restore). pvalid
  // guards staleness; all access under Engine::mu.
  std::vector<double> pamax, pss, psabs;
  bool pvalid = false;
  // r09 convergence telemetry (st_engine_link_obs): origin-stamp age of the
  // latest traced message applied FROM this link, and its hop distance.
  // Updated at flush under Engine::mu.
  uint64_t stale_ns = 0;
  uint32_t last_hops = 0;
  // r10 subscriber link mode (st_engine_attach_sub): read-only leaf on the
  // other end — UNLEDGERED (no unacked entries, no ACKs expected, no
  // go-back-N; loss shows up as a seq gap the subscriber repairs with a
  // resync handshake), optionally RANGE-FILTERED (only words
  // [wlo, wlo+wcnt) of each frame ship, as kRData messages — the
  // paged-subscription discipline), with periodic kFresh drain marks so an
  // idle subscriber can still verify its staleness bound.
  bool subscriber = false;
  bool ranged = false;
  int64_t wlo = 0, wcnt = 0;  // subscribed word range
  uint64_t fresh_interval_ns = 0;
  uint64_t last_fresh_ns = 0;
  // r11 adaptive precision. peer_sign2: the OTHER end advertised sign2
  // decode capability (SYNC/WELCOME flags; emission is gated on it — see
  // kPrecBit). prec: the governor's current choice for this link (1 or 2).
  // gov_*: the telemetry loop's state — previous residual RMS sample and
  // consecutive stall/quiet votes (2 votes with hysteresis, so one noisy
  // interval can't flap the link).
  //
  // Byte-bound gating (the loop's stability half): sign2 buys more
  // residual mass PER BYTE (the lab measurement this PR promotes) at 2x
  // the bytes per frame — so the upshift only pays when BYTES are the
  // link's scarce resource. A loopback/compute-bound link at its
  // equilibrium is frame-bound, not byte-bound: upshifting it just
  // halves the frame rate, and the rms there is a flat sawtooth whose
  // discrete jitter (integer multiples of one add's norm) defeats every
  // trend-based verdict — both a one-shot probation (a mark captured
  // during the join transient "passes" forever: bimodal 26-vs-44 GB/s
  // bench runs) and a continuous-progress rule (sawtooth dips read as
  // progress: flapping). The honest discriminator is direct byte
  // BACKPRESSURE, which the send path already observes: a send attempt
  // that sat out its full timeout on a full sendq (gov_bp, counted per
  // beat) or a go-back-N window that closed (window_blocked — the peer
  // acks slower than we produce). Healthy loopback shows NEITHER
  // (measured: zero events over 8 s saturated), a capped or
  // NIC-saturated or chaos-storm link shows them continuously. Growth
  // votes therefore only count while byte-bound, and sign2 holds
  // exactly as long as the byte-bound condition does (kGovStall quiet
  // beats to lift, so a bursty storm doesn't flap the link) or the
  // residual quiesces.
  bool peer_sign2 = false;
  // r14: the peer decodes the aligned v3 framing (advertised via the
  // SYNC/WELCOME r14 capability flag; st_engine_link_wire_v3)
  bool wire_v3 = false;
  int prec = 1;
  double gov_prev = -1.0;
  uint64_t gov_last_ns = 0;
  int gov_up = 0, gov_down = 0;
  uint32_t gov_bp = 0;   // byte-backpressure events since the last beat
  int gov_quiet = 0;     // consecutive beats without byte pressure
};

constexpr int kGovStall = 8;  // quiet beats before sign2 stands down
                              // (~0.8 s at the default beat)

struct Engine {
  void* node = nullptr;
  int64_t L = 0, total = 0, total_n = 0, W = 0;
  std::vector<int64_t> off, ns, padded;
  int policy = kPow2Rms;
  bool per_leaf = true;
  int burst = 1;         // frames per BURST message (1 => DATA framing)
  int32_t recv_cap = 0;  // recv buffer size (max wire message)
  // Per-link send quarantine (TransportConfig.quarantine_send_failures):
  // after this many CONSECUTIVE backpressure failures (~0.1 s each) the
  // link is torn down via st_node_drop_link and re-grafted instead of
  // retried hot — a peer that stopped draining but kept its socket open
  // would otherwise pin this sender until the liveness timeout.
  // 0 = disabled (retry until the liveness timeout kills the link).
  int32_t quarantine = 0;
  // Go-back-N delivery timer (TransportConfig.ack_timeout_sec): when a
  // link's oldest unacked message has waited this long, the sender
  // retransmits the whole unacked tail byte-identical (same wire seqs —
  // the receiver dedups, so a spurious retransmit is harmless). After
  // ack_retry_limit fruitless rounds the link is a black hole and is torn
  // down for re-graft. 0 = disabled. Native framing only (compat has no
  // ACKs at all).
  double ack_timeout = 0.0;
  // Retransmission rounds with zero ACK progress before a link is declared
  // a black hole and torn down for re-graft
  // (TransportConfig.ack_retry_limit; same knob as the Python tier).
  int32_t ack_retry_limit = 8;
  // Wire-compat mode (reference raw protocol, comm/wire.py
  // encode_compat_frame): every wire message is exactly compat_bytes =
  // [f32 scale LE][ceil(n/8) bitmask bytes] — no kind byte, no bursts, no
  // ACKs (so no ledger: the reference protocol cannot acknowledge).
  // 0 = native framing.
  int32_t compat_bytes = 0;

  TxPool txpool;  // native-framing tx slot ring (see TxSlot)

  // Data-plane mutex (mirrors the Python tier: ONE lock over values,
  // residuals, ledgers; codec loops run under it, socket I/O outside it —
  // except flush_acks/FRESH beats, which send with a ZERO timeout from
  // under it by design). Declared before the fields it guards so the
  // ST_GUARDED_BY references resolve.
  StMutex mu;
  std::vector<float> values ST_GUARDED_BY(mu);
  // The whole ELink record — residual, ledger, governor state — is guarded
  // by mu as a unit: the analysis checks every access to the map itself,
  // and no code path retains an ELink reference across an unlock.
  std::map<int32_t, ELink> links ST_GUARDED_BY(mu);
  // The re-graft carry as a LIVE slot (the reference's unconnected-slot
  // mechanism, src/sharedtensor.c:124-126/:338-342): a dead uplink's
  // rolled-back residual parks here and KEEPS accumulating add()/flood
  // mass while the node is orphaned — an add made with no links must ride
  // the re-graft, or the join snapshot presents it as tree-known state and
  // the parent's diff seed erases it everywhere (measured as tree-wide
  // loss in the churn soak before this existed).
  std::vector<float> carry ST_GUARDED_BY(mu);
  bool has_carry ST_GUARDED_BY(mu) = false;
  // A severed uplink's unacknowledged messages, rolled into the carry by
  // st_engine_stash_carry and kept (their tx slots' ledger references
  // with them: at most kSendWindow messages) until the re-join's WELCOME
  // says how many of them the parent applied. The diff handshake brings
  // those back from the parent, so st_engine_retract_kept takes them out
  // of this node's state (the port peer's SYNC_FLAG_PREV_LINK handshake);
  // a WELCOME without the count drops the record (retract with 0).
  std::deque<SentMsg> kept ST_GUARDED_BY(mu);

  // r11 staged adds: st_engine_add used to take the data-plane mutex for
  // its two full-table passes, serializing every trainer add behind
  // whatever multi-pass message quantize held it (measured: 2.9 ms per
  // add at 1 Mi under load, the saturated pipeline's limiter). Adds now
  // accumulate into `upend` under add_mu ONLY — sanitize+clip fused, the
  // same kernel — and every data-plane path that reads values/residuals
  // folds the pending sum in first (fold_pending: the old add body, run
  // under e->mu at the next safe point). Lock order: e->mu -> add_mu,
  // never the reverse; add() takes only add_mu. The pending trace
  // re-seed stages through pend_gen the same way.
  StMutex add_mu ST_ACQUIRED_AFTER(mu);
  // upend: the trainers' staged accumulation (add_mu alone). ufold: the
  // fold scratch — swapped in under BOTH locks (fold_pending), then read
  // and re-zeroed under mu alone, so mu is its guard.
  std::vector<float> upend ST_GUARDED_BY(add_mu);
  std::vector<float> ufold ST_GUARDED_BY(mu);
  std::atomic<bool> has_pending{false};
  std::atomic<uint64_t> pend_gen{0};

  // sender wake (missed-wakeup-safe sequence counter)
  StMutex wmu;
  std::condition_variable wcv;
  uint64_t wseq ST_GUARDED_BY(wmu) = 0;

  // control messages (non DATA/BURST/ACK) surfaced to Python
  StMutex cmu;
  std::deque<std::pair<int32_t, std::vector<uint8_t>>> ctrl
      ST_GUARDED_BY(cmu);

  std::atomic<bool> stop{false};
  // Sender pass counter (r12): incremented at the top of every sender-loop
  // iteration. st_engine_pause's synchronous wait uses it to bound the one
  // in-flight pass that may still enqueue data produced from pre-pause
  // state — the barrier's SNAP marker must follow the sender's LAST data
  // message on every link, and a marker enqueued while a pass is mid-
  // flight would otherwise be overtaken (consistent-cut ordering).
  std::atomic<uint64_t> sender_pass{0};
  // r12 lifecycle quiesce (st_engine_pause): the sender produces NO new
  // data frames while paused — quantize/encode/send of fresh residual mass
  // stops, so the cluster-wide consistent cut can drain every in-flight
  // ledger to empty. Everything else keeps running: ACK processing,
  // go-back-N retransmission (in-flight delivery must COMPLETE for the
  // barrier to quiesce), control traffic, and FRESH beats on already-
  // drained subscriber links (they only fire when the residual is empty,
  // so a paused-but-current subscriber keeps verifying its bound instead
  // of going stale — and a paused-with-mass one gets no mark, so a read
  // across the cut can never falsely verify).
  std::atomic<bool> paused{false};
  // Sealed ingress (graceful-leave step 1): DATA/BURST messages are popped
  // and DISCARDED — not applied, not counted, not ACKed — so their senders'
  // ledgers keep them and re-deliver after our departure's re-graft. This
  // closes the leave-time loss window: without it, a frame applied+ACKed
  // in the instant between drain()'s last check and close() puts mass into
  // residuals that die with us, and its sender (holding our ACK) never
  // re-sends. ACK and control handling continue (our own drain needs them).
  std::atomic<bool> sealed{false};
  std::atomic<uint64_t> frames_out{0}, frames_in{0}, updates{0};
  std::atomic<uint64_t> msgs_out{0}, msgs_in{0};
  // r08 obs counters (st_engine_counters[8..11]): go-back-N retransmitted
  // messages, dup/gap discards at the receive acceptance check, and the
  // ACK round-trip aggregate (sum of ns + sample count — the C hot path
  // keeps no buckets; Python renders mean / exports sum+count).
  std::atomic<uint64_t> retx_msgs{0}, dedup_discards{0};
  std::atomic<uint64_t> rtt_ns_total{0}, rtt_msgs{0};
  // r09 trace aggregates (st_engine_counters[12..15]): hop-count sum +
  // sample count over applied traced messages (st_update_hops on the
  // Python tier keeps buckets; the C hot path exports sum/count like the
  // RTT pair), the most recent apply-time staleness, and how many applied
  // data messages carried a v2 trace stamp at all.
  std::atomic<uint64_t> hops_sum{0}, hops_msgs{0};
  std::atomic<uint64_t> staleness_ns_last{0};
  std::atomic<uint64_t> traced_msgs_in{0};
  // r10 serving tier (st_engine_counters[16..17]): unledgered data
  // messages sent to subscriber links (OUTSIDE the msgs_out taxonomy —
  // that one stays "ACK-ledgered wire messages" on both tiers) and kFresh
  // drain marks delivered.
  std::atomic<uint64_t> sub_msgs_out{0}, sub_fresh_out{0};
  // r11 adaptive precision (st_engine_counters[18..21]): governor
  // upshifts/downshifts, and sign2 frames sent/applied (subsets of
  // frames_out/frames_in — the taxonomy equalities are precision-blind).
  std::atomic<uint64_t> prec_upshifts{0}, prec_downshifts{0};
  std::atomic<uint64_t> frames2_out{0}, frames2_in{0};
  // r11 codec config (st_engine_set_codec; called between create and
  // start). prec_mode: 0 = fixed 1-bit, 1 = telemetry-adaptive (the
  // governor may upshift capable links to sign2), 2 = fixed sign2 on
  // capable links (A/B arms). gov_up_ratio: upshift when the residual RMS
  // fails to decay below ratio*previous for 2 consecutive beats (the
  // 1-bit codec is not keeping up); gov_down_ratio: downshift when it
  // decays below this ratio (or quiesces). cascade: frames quantized per
  // memory pass on the ledgered 1-bit/sign2 paths (1 = the r10 per-frame
  // re-measured schedule).
  int prec_mode = 0;
  double gov_up_ratio = 1.05, gov_down_ratio = 0.5;
  double gov_interval = 0.1;
  int cascade = 1;
  // r09 wire format: stamp outgoing DATA/BURST with the v2 trace context
  // (0 = v1 framing, byte-identical to r08 — the receive side accepts
  // both regardless, so mixed trees interop; ObsConfig.trace_wire).
  int32_t trace_wire = 0;
  // Pending trace stamp (under mu): provenance of the latest update folded
  // into the residuals — re-seeded by add() (this node, now, 0 hops),
  // advanced by every traced apply (origin kept, hops + 1). Approximate by
  // design: residual coalescing means one outgoing message can carry many
  // generations' mass; it is stamped with the newest (README "Cluster
  // observability" documents the semantics).
  uint32_t t_origin ST_GUARDED_BY(mu) = 0;
  uint64_t t_gen ST_GUARDED_BY(mu) = 0;
  uint32_t t_hops ST_GUARDED_BY(mu) = 0;
  bool t_has ST_GUARDED_BY(mu) = false;
  uint32_t obs_id = 0;  // the node's process-unique obs id (event tag)
  std::thread send_thread, recv_thread;

  void wake() ST_EXCLUDES(wmu) {
    {
      StLockGuard lk(wmu);
      wseq++;
    }
    wcv.notify_all();
  }
};

// Fold the staged pending add (st_engine_add) into values + every
// residual + the carry — the pre-r11 add body, run at the next safe
// point by whoever holds e->mu. One atomic-bool check when idle.
void fold_pending(Engine* e) ST_REQUIRES(e->mu) {
  if (!e->has_pending.load(std::memory_order_acquire)) return;
  {
    StLockGuard alk(e->add_mu);
    if (!e->has_pending.load(std::memory_order_relaxed)) return;
    // fold scratch sized lazily HERE (under both locks — ufold is
    // mu-guarded, and st_engine_add holds only add_mu)
    if (e->ufold.size() != e->upend.size())
      e->ufold.assign(e->upend.size(), 0.0f);
    // swap the accumulation buffer out (ufold is pre-zeroed — see the
    // fill below) so concurrent adds keep landing while we fold
    std::swap(e->upend, e->ufold);
    e->has_pending.store(false, std::memory_order_release);
  }
  const float* u = e->ufold.data();
  stc_accumulate_update_to(e->values.data(), e->values.data(), u,
                           e->off.data(), e->ns.data(), e->padded.data(),
                           e->L);
  for (auto& kv : e->links) {
    ELink& lk2 = kv.second;
    if ((int64_t)lk2.pamax.size() != e->L) {
      lk2.pamax.resize((size_t)e->L);
      lk2.pss.resize((size_t)e->L);
      lk2.psabs.resize((size_t)e->L);
    }
    stc_accumulate_update_to_partials(
        lk2.resid.data(), lk2.resid.data(), u, e->off.data(), e->ns.data(),
        e->padded.data(), e->L, lk2.pamax.data(), lk2.pss.data(),
        lk2.psabs.data());
    lk2.pvalid = true;
    lk2.dirty = true;
  }
  if (e->has_carry)
    stc_accumulate_update_to(e->carry.data(), e->carry.data(), u,
                             e->off.data(), e->ns.data(), e->padded.data(),
                             e->L);
  std::fill(e->ufold.begin(), e->ufold.end(), 0.0f);  // ready for re-swap
  uint64_t g = e->pend_gen.exchange(0, std::memory_order_acq_rel);
  if (e->trace_wire && g) {
    // a local update is a fresh generation: re-seed the pending stamp
    // (origin = this node, generation = the add's clock reading, 0 hops)
    e->t_origin = e->obs_id;
    e->t_gen = g;
    e->t_hops = 0;
    e->t_has = true;
  }
}

// scale = policy(partials); zero when the leaf is all-zero or the result is
// non-finite. Same math as ops/codec_np.compute_scales_np's native branch:
// double math, cast to f32, pow2-floor by exponent mask.
void scales_from_partials(Engine* e, const std::vector<double>& amax,
                          const std::vector<double>& ss,
                          const std::vector<double>& sabs, float* out) {
  // NON-mutating (the inputs may be a link's partials cache): the
  // aggregate for per_leaf == false lives in locals.
  double g_am = 0, g_s2 = 0, g_sa = 0;
  if (!e->per_leaf) {
    for (int64_t i = 0; i < e->L; i++) {
      if (amax[i] > g_am) g_am = amax[i];
      g_s2 += ss[i];
      g_sa += sabs[i];
    }
  }
  for (int64_t i = 0; i < e->L; i++) {
    double n = e->per_leaf ? (double)e->ns[i] : (double)e->total_n;
    double am = e->per_leaf ? amax[i] : g_am;
    double s2 = e->per_leaf ? ss[i] : g_s2;
    double sa = e->per_leaf ? sabs[i] : g_sa;
    float s;
    if (e->policy == kAbsMean) {
      s = (float)(sa / n);
    } else {
      s = (float)std::sqrt(s2 / n);
      if (e->policy == kPow2Rms) {
        union {
          float f;
          uint32_t u;
        } b;
        b.f = s;
        b.u &= 0x7F800000u;  // 2^floor(log2 s); subnormals -> 0
        s = b.f;
      }
    }
    out[i] = (am > 0 && std::isfinite(s)) ? s : 0.0f;
  }
}

bool any_nonzero(const float* s, int64_t L) {
  for (int64_t i = 0; i < L; i++)
    if (s[i] != 0.0f) return true;
  return false;
}

// frame f of a ledgered message: its scales and (first) word plane
void msg_frame(Engine* e, const SentMsg& msg, int32_t f, const float** fs,
               const uint32_t** fw) {
  size_t per = (size_t)e->L * 4 + (size_t)e->W * 4;
  size_t fb = msg.prec == 2 ? per + (size_t)e->W * 4 : per;
  if (msg.slot) {
    const uint8_t* body = msg.slot->buf.data() + kBodyOff + (size_t)f * fb;
    *fs = (const float*)body;
    *fw = (const uint32_t*)(body + (size_t)e->L * 4);
  } else {
    *fs = msg.scales.data() + (size_t)f * e->L;
    *fw = msg.words.data() + (size_t)f * e->W;
  }
}

// Roll every unacked message's error feedback back into the residual
// (core.SharedTensor._unapply: re-applying a frame to the residual restores
// the pre-quantize state bit-for-bit). Native-framing entries read their
// frames straight out of the ledgered tx slot (the slot body offsets are
// 4-aligned by construction — see TxSlot) and drop the ledger's pool
// reference — or, given `keep`, moves each entry (its reference with it)
// there. Caller holds e->mu.
void rollback_unacked(Engine* e, ELink& lk,
                      std::deque<SentMsg>* keep = nullptr) ST_REQUIRES(e->mu) {
  for (auto& msg : lk.unacked) {
    // frame stride follows the ledgered message's precision (r11): a
    // sign2 frame carries a second (magnitude) word plane (msg_frame)
    for (int32_t f = 0; f < msg.nframes; f++) {
      const float* fs;
      const uint32_t* fw;
      msg_frame(e, msg, f, &fs, &fw);
      if (msg.prec == 2)
        stc_apply_frame2(lk.resid.data(), lk.resid.data(), e->off.data(),
                         e->ns.data(), e->padded.data(), e->L, e->W, fs, fw);
      else
        stc_apply_frame(lk.resid.data(), lk.resid.data(), e->off.data(),
                        e->ns.data(), e->padded.data(), e->L, fs, fw);
    }
    if (keep)
      keep->push_back(std::move(msg));
    else if (msg.slot)
      e->txpool.unref(msg.slot);
  }
  lk.unacked.clear();
  lk.pvalid = false;  // rollback bypasses the fused-partials kernels
}

// Drop ledger entries that were rolled back, and their slot references.
void drop_msgs(Engine* e, std::deque<SentMsg>& msgs) ST_REQUIRES(e->mu) {
  for (auto& msg : msgs)
    if (msg.slot) e->txpool.unref(msg.slot);
  msgs.clear();
}

// Apply k decoded frames from `src_link` to the replica and every OTHER
// link's residual (split-horizon flood). Caller holds e->mu.
// prec (r11): 1 = sign-bit frames (words is k*W), 2 = sign2 frames (words
// is k*2W — per frame, sign plane then magnitude plane). A receive batch
// flushes on precision change, so one call is always homogeneous.
void apply_batch(Engine* e, int32_t src_link, int32_t k, const float* scales,
                 const uint32_t* words, int prec) ST_REQUIRES(e->mu) {
  // NOTE: dead links are NOT skipped here (only the I/O loops skip them):
  // a dead link's residual keeps accumulating until Python detaches it —
  // that residual IS the carry the re-graft owes, and mass applied in the
  // death-to-detach window would otherwise vanish from the carry AND be
  // claimed by the re-join snapshot, losing it tree-wide
  // (core.SharedTensor applies to all links until drop_link, same reason).
  // Corruption-zeroed (all-zero-scale) frames apply as no-ops and must
  // count NOWHERE: the metrics taxonomy promises a quiesced pair satisfies
  // sender.frames_out == receiver.frames_in (idle frames count on neither
  // side), and a sender never emits all-zero frames — counting a zeroed
  // frame here would read as a phantom discrepancy exactly when an
  // operator is debugging a corrupt link.
  uint64_t applied = 0;
  for (int32_t f = 0; f < k; f++)
    if (any_nonzero(scales + (size_t)f * e->L, e->L)) applied++;
  if (applied == 0) return;
  // k-frame fused apply (stc_apply_frames / its sign2 twin): ONE pass per
  // target regardless of k — no delta buffer (the old k>1 path paid k
  // read-modify-write passes over a total*4 delta before touching any
  // target; at 16 Mi that was k*128 MiB of traffic). Residual targets
  // refresh their scale-partials cache in the same pass (ELink::pvalid).
  auto apply = [&](const float* in, float* out, double* pa, double* ps,
                   double* pb) {
    if (prec == 2)
      stc_apply_frames2(in, out, e->off.data(), e->ns.data(),
                        e->padded.data(), e->L, e->W, k, scales, words, pa,
                        ps, pb);
    else
      stc_apply_frames(in, out, e->off.data(), e->ns.data(),
                       e->padded.data(), e->L, e->W, k, scales, words, pa,
                       ps, pb);
  };
  apply(e->values.data(), e->values.data(), nullptr, nullptr, nullptr);
  for (auto& kv : e->links) {
    if (kv.first == src_link) continue;
    ELink& lk = kv.second;
    if ((int64_t)lk.pamax.size() != e->L) {
      lk.pamax.resize((size_t)e->L);
      lk.pss.resize((size_t)e->L);
      lk.psabs.resize((size_t)e->L);
    }
    apply(lk.resid.data(), lk.resid.data(), lk.pamax.data(), lk.pss.data(),
          lk.psabs.data());
    lk.pvalid = true;
    lk.dirty = true;
  }
  if (e->has_carry)
    apply(e->carry.data(), e->carry.data(), nullptr, nullptr, nullptr);
  e->frames_in += applied;
  if (prec == 2) e->frames2_in += applied;
}

// apply_batch's r14 zero-repack twin: k frames applied STRAIGHT FROM the
// v3 wire body (per frame f: [scales L*4][words ...] at body + f*stride;
// the 24-byte aligned header guarantees the typed loads are legal). Same
// flood/carry/accounting semantics — only the repack copy is gone. The
// caller has already zeroed non-finite scales in place (the loaned rx
// buffer is process-local transport memory, safe to sanitize). Caller
// holds e->mu.
void apply_batch_wire(Engine* e, int32_t src_link, int32_t k,
                      const uint8_t* body, size_t stride, int prec)
    ST_REQUIRES(e->mu) {
  uint64_t applied = 0;
  for (int32_t f = 0; f < k; f++)
    if (any_nonzero((const float*)(body + (size_t)f * stride), e->L))
      applied++;
  if (applied == 0) return;
  auto apply = [&](const float* in, float* out, double* pa, double* ps,
                   double* pb) {
    if (prec == 2)
      stc_apply_frames2_wire(in, out, e->off.data(), e->ns.data(),
                             e->padded.data(), e->L, e->W, k, body,
                             (int64_t)stride, pa, ps, pb);
    else
      stc_apply_frames_wire(in, out, e->off.data(), e->ns.data(),
                            e->padded.data(), e->L, e->W, k, body,
                            (int64_t)stride, pa, ps, pb);
  };
  apply(e->values.data(), e->values.data(), nullptr, nullptr, nullptr);
  for (auto& kv : e->links) {
    if (kv.first == src_link) continue;
    ELink& lk = kv.second;
    if ((int64_t)lk.pamax.size() != e->L) {
      lk.pamax.resize((size_t)e->L);
      lk.pss.resize((size_t)e->L);
      lk.psabs.resize((size_t)e->L);
    }
    apply(lk.resid.data(), lk.resid.data(), lk.pamax.data(), lk.pss.data(),
          lk.psabs.data());
    lk.pvalid = true;
    lk.dirty = true;
  }
  if (e->has_carry)
    apply(e->carry.data(), e->carry.data(), nullptr, nullptr, nullptr);
  e->frames_in += applied;
  if (prec == 2) e->frames2_in += applied;
}

// ---- sender ---------------------------------------------------------------

size_t frame_bytes(const Engine* e) {
  return (size_t)e->L * 4 + (size_t)e->W * 4;
}

// Go-back-N retransmission pass (Engine::ack_timeout; the native twin of
// comm/peer.py _check_retransmit). For every live link whose oldest
// unacked message has waited past the timeout, resend the HEAD of the
// unacked tail BYTE-IDENTICAL — with the r07 slot ring that is literal:
// the ledger entry IS the wire bytes, so a retransmit is a new zero-copy
// reference on the same slot, never a re-encode. After ack_retry_limit
// fruitless rounds tear the link down (rollback -> dead -> drop) so
// LINK_DOWN -> carry -> re-graft recovers every undelivered frame on a
// fresh link instead of retrying forever.
void retransmit_pass(Engine* e, const std::vector<int32_t>& ids)
    ST_EXCLUDES(e->mu) {
  auto now = EClock::now();
  for (int32_t id : ids) {
    std::vector<TxSlot*> tail;
    bool teardown = false;
    {
      StLockGuard lk(e->mu);
      auto it = e->links.find(id);
      if (it == e->links.end() || it->second.dead) continue;
      ELink& lk2 = it->second;
      if (lk2.unacked.empty()) continue;
      double waited =
          std::chrono::duration<double>(now - lk2.ack_progress).count();
      // per-round exponential backoff, capped 8x (peer.py
      // _check_retransmit's twin): a flat timer would retransmit a
      // healthy-but-saturated link whose burst is still queued locally
      int32_t shift = lk2.retx_rounds < 3 ? lk2.retx_rounds : 3;
      if (waited < e->ack_timeout * (double)(1 << shift)) continue;
      lk2.retx_rounds++;
      lk2.ack_progress = now;
      if (lk2.retx_rounds > e->ack_retry_limit) {
        rollback_unacked(e, lk2, &lk2.rolled);
        lk2.dead = true;
        teardown = true;
      } else {
        // head prefix only: O(kRetxPrefix) pointer grabs under e->mu (the
        // old path deep-copied the messages' frame vectors here), and
        // only the head can restore the receiver's in-order progress.
        // Each grabbed slot takes an in-flight reference NOW, under the
        // lock, so a racing ACK pop cannot recycle it mid-send.
        size_t k = lk2.unacked.size() < kRetxPrefix ? lk2.unacked.size()
                                                    : kRetxPrefix;
        for (size_t i = 0; i < k; i++) {
          TxSlot* s = lk2.unacked[i].slot;
          s->refs.fetch_add(1, std::memory_order_relaxed);
          tail.push_back(s);
        }
      }
    }
    if (teardown) {
      st_obs_emit(e->obs_id, kEvBlackhole, id, (uint64_t)e->ack_retry_limit);
      st_node_drop_link(e->node, id);
      continue;
    }
    if (!tail.empty()) {
      e->retx_msgs += (uint64_t)tail.size();
      st_obs_emit(e->obs_id, kEvRetransmit, id, (uint64_t)tail.size());
    }
    for (size_t i = 0; i < tail.size(); i++) {
      TxSlot* s = tail[i];
      int32_t r =
          st_node_send_zc(e->node, id, s->buf.data() + s->wire_off,
                          (int32_t)s->wire_len, 0.1, tx_slot_release, s);
      if (r != 1) {
        // not enqueued: the transport took no ownership — drop our
        // reference for this and every remaining tail slot, and let the
        // next pass (or LINK_DOWN) handle it
        for (size_t j = i; j < tail.size(); j++) e->txpool.unref(tail[j]);
        break;
      }
    }
  }
}

// One unledgered send with the same backpressure/quarantine discipline as
// the main path (r10 subscriber links). Returns false when the link died
// or was quarantined — the caller marks it dead and rolls its frames back.
bool sub_send(Engine* e, int32_t id, const uint8_t* p, size_t n) {
  int32_t fails = 0;
  while (!e->stop.load()) {
    int32_t r = st_node_send(e->node, id, p, (int32_t)n, 0.1);
    if (r == 1) return true;
    if (r < 0) return false;
    if (e->quarantine > 0 && ++fails >= e->quarantine) {
      st_obs_emit(e->obs_id, kEvQuarantine, id, (uint64_t)fails);
      st_node_drop_link(e->node, id);
      return false;
    }
  }
  return false;
}

void sender_loop(Engine* e) {
  std::vector<uint8_t> payload;
  std::vector<float> scales((size_t)e->L);
  std::vector<double> amax((size_t)e->L), ss((size_t)e->L),
      sabs((size_t)e->L);
  // r11 cascade schedule rows (frame-major, contiguous k*L — the kernels'
  // scale layout; the slot copies are per-frame)
  std::vector<float> sched((size_t)64 * e->L);
  const uint64_t gov_interval_ns =
      e->gov_interval > 0 ? (uint64_t)(e->gov_interval * 1e9) : 100000000ull;
  while (!e->stop.load()) {
    e->sender_pass.fetch_add(1);  // pass boundary (st_engine_pause sync)
    uint64_t seq_before;
    {
      StLockGuard lk(e->wmu);
      seq_before = e->wseq;
    }
    bool sent_any = false;
    std::vector<int32_t> ids;
    {
      StLockGuard lk(e->mu);
      for (auto& kv : e->links)
        if (!kv.second.dead) ids.push_back(kv.first);
    }
    // one clock read per pass feeds every link's governor beat (r11)
    uint64_t pass_ns = e->prec_mode == 1 ? st_obs_now_ns() : 0;
    for (int32_t id : ids) {
      if (e->stop.load()) return;
      SentMsg msg;
      TxSlot* slot = nullptr;
      size_t per = frame_bytes(e);
      int mprec = 1;  // this message's frame precision
      // r10 subscriber-link state, captured under e->mu for the unledgered
      // send path below (incl. the trace stamp — the ledgered path reads it
      // while packing headers under the same lock)
      bool sub = false, sub_ranged = false;
      int64_t sub_wlo = 0, sub_wcnt = 0;
      uint32_t tr_o = 0;
      uint64_t tr_g = 0;
      uint8_t tr_h = 0;
      {
        StLockGuard lk(e->mu);
        fold_pending(e);  // staged adds land before this link quantizes
        auto it = e->links.find(id);
        if (it == e->links.end() || it->second.dead) continue;
        ELink& lk2 = it->second;
        sub = lk2.subscriber;
        if (sub) {
          sub_ranged = lk2.ranged;
          sub_wlo = lk2.wlo;
          sub_wcnt = lk2.wcnt;
          if (lk2.fresh_interval_ns && !lk2.dirty) {
            // FRESH beat: the residual is fully drained — "as of now you
            // have everything I have, through message tx_seq" (the seq
            // makes the mark verifiable: a subscriber missing the stream
            // tail resyncs instead of falsely trusting it). Sent from
            // under e->mu with a zero timeout, same discipline as
            // flush_acks (lossy: a bounced beat retries next pass).
            uint64_t now = st_obs_now_ns();
            if (now - lk2.last_fresh_ns >= lk2.fresh_interval_ns) {
              uint8_t fb[13];
              fb[0] = kFresh;
              std::memcpy(fb + 1, &now, 8);
              uint32_t ls = (uint32_t)lk2.tx_seq;
              std::memcpy(fb + 9, &ls, 4);
              if (st_node_send(e->node, id, fb, 13, 0.0) == 1) {
                lk2.last_fresh_ns = now;
                e->sub_fresh_out++;
              }
            }
          }
        }
        // r11 precision governor — the first closed telemetry->data-plane
        // loop: the same per-link residual RMS the r09 st_residual_norm
        // gauge serves (the pss partials cache, O(L) under e->mu) drives
        // this link's wire precision. A link whose residual GROWS between
        // beats (rms > up_ratio * prev: the stream is falling behind the
        // mass arriving — chaos, retransmission storms, a stalled peer)
        // upshifts to the sign2 2-bit codec; one that drains fast or
        // quiesces (rms < down_ratio * prev, or zero) downshifts back. A
        // healthy saturated link (flat rms at equilibrium) stays 1-bit. Two consecutive
        // votes with reset-on-contrary give hysteresis so one noisy beat
        // can't flap the link. Emission stays gated on the peer's
        // advertised capability (kPrecBit note).
        if (e->prec_mode == 1 && !sub && !e->compat_bytes &&
            lk2.peer_sign2 &&
            pass_ns - lk2.gov_last_ns >= gov_interval_ns && lk2.pvalid) {
          double gss = 0;
          for (int64_t i = 0; i < e->L; i++) gss += lk2.pss[i];
          double rms = std::sqrt(gss / (double)e->total_n);
          // byte pressure harvested per beat (struct comment): sendq
          // bounces since the last beat, or a closed go-back-N window
          bool byte_bound = lk2.gov_bp > 0 || lk2.window_blocked;
          lk2.gov_bp = 0;
          lk2.gov_quiet = byte_bound ? 0 : lk2.gov_quiet + 1;
          if (lk2.gov_prev >= 0.0) {
            if (byte_bound && rms > 0 &&
                rms > lk2.gov_prev * e->gov_up_ratio) {
              // growing residual on a byte-bound link: the wire cannot
              // move the mass at 1 bit/element — the regime sign2's
              // per-byte advantage exists for
              lk2.gov_up++;
              lk2.gov_down = 0;
            } else if (rms <= 0 || rms < lk2.gov_prev * e->gov_down_ratio) {
              lk2.gov_down++;
              lk2.gov_up = 0;
            } else {
              lk2.gov_up = 0;
              lk2.gov_down = 0;
            }
            if (lk2.prec == 1 && lk2.gov_up >= 2) {
              lk2.prec = 2;
              lk2.gov_up = 0;
              e->prec_upshifts++;
              st_obs_emit(e->obs_id, kEvPrecShift, id, 2);
            } else if (lk2.prec == 2 &&
                       (lk2.gov_down >= 2 || lk2.gov_quiet >= kGovStall)) {
              // stand down when the residual quiesces (sign2 did its
              // job / the load vanished) or the byte-bound condition
              // lifts for kGovStall beats (bytes are no longer scarce —
              // the half-cost wire format moves the same frames)
              lk2.prec = 1;
              lk2.gov_down = 0;
              e->prec_downshifts++;
              st_obs_emit(e->obs_id, kEvPrecShift, id, 1);
            }
          }
          lk2.gov_prev = rms;
          lk2.gov_last_ns = pass_ns;
        }
        // r12 lifecycle quiesce: paused means no NEW production on any
        // link (the struct comment). Placed after the FRESH beat (which
        // only fires on a drained residual) and before the quantize path.
        // seq_cst load: st_engine_pause's pass-boundary handshake counts
        // on a pass that starts after the store observing it.
        if (e->paused.load()) continue;
        if (!lk2.dirty) continue;
        // go-back-N send window: a full unacked ledger (stalled peer)
        // stops NEW production on this link; the residual keeps
        // accumulating and quantizes once ACKs reopen the window — and,
        // with the ledger-as-slot design, bounds the live tx ring slots
        // per link at kSendWindow (the pool cannot grow past it)
        if (!e->compat_bytes && lk2.unacked.size() >= kSendWindow) {
          if (!lk2.window_blocked) {
            lk2.window_blocked = true;
            st_obs_emit(e->obs_id, kEvWindowStall, id,
                        (uint64_t)lk2.unacked.size());
          }
          continue;
        }
        lk2.window_blocked = false;
        // quantize up to `burst` successive halvings of the residual,
        // stopping at the first all-zero-scale frame (idle). EVERY quantize
        // pass accumulates the residual's scale partials fused
        // (stc_quantize_ef_partials) — one memory pass per frame instead of
        // quantize-then-rescan. Frame 0's partials come from the link's
        // cache when valid (refreshed by the fused add/flood passes), so
        // the standalone stc_scale_partials scan only runs after the rare
        // writes that bypass the fused kernels (rollback, restore) — at
        // 16 Mi / burst cap 1 that scan was a full 64 MiB read per message.
        //
        // r07 zero-copy: on the native framing the quantize target IS the
        // wire message — scales and sign words land at their final offsets
        // in a pooled tx slot (TxSlot layout), which then serves as ledger
        // entry, retransmission source, and scatter-gather send buffer
        // with no further copies.
        msg.nframes = 0;
        uint8_t* body = nullptr;
        if (!e->compat_bytes && !sub) {
          // subscriber links are unledgered: no slot (the ledger entry IS
          // the slot on the ledgered path) — frames quantize into the
          // msg.scales/words buffers like compat and encode below
          slot = e->txpool.acquire();
          body = slot->buf.data() + kBodyOff;
        }
        if ((int64_t)lk2.pamax.size() != e->L) {
          lk2.pamax.resize((size_t)e->L);
          lk2.pss.resize((size_t)e->L);
          lk2.psabs.resize((size_t)e->L);
          lk2.pvalid = false;
        }
        if (sub_ranged) {
          // range discipline: out-of-range residual is mass this link's
          // receiver will never get (adds/floods refill the FULL residual
          // between passes) — drop it BEFORE scale selection, so frames
          // never budget scale for it and the link goes idle the moment
          // its own pages drain (without this, the dropped mass decays
          // geometrically across dozens of frames of useless traffic)
          std::fill(lk2.resid.begin(), lk2.resid.begin() + sub_wlo * 32,
                    0.0f);
          std::fill(lk2.resid.begin() + (sub_wlo + sub_wcnt) * 32,
                    lk2.resid.end(), 0.0f);
          lk2.pvalid = false;  // cached partials counted the dropped mass
        }
        if (lk2.pvalid) {
          std::copy(lk2.pamax.begin(), lk2.pamax.end(), amax.begin());
          std::copy(lk2.pss.begin(), lk2.pss.end(), ss.begin());
          std::copy(lk2.psabs.begin(), lk2.psabs.end(), sabs.begin());
        } else {
          stc_scale_partials(lk2.resid.data(), e->off.data(), e->ns.data(),
                             e->L, amax.data(), ss.data(), sabs.data());
        }
        // r11: this message's precision, decided under e->mu. Ledgered
        // links only (sub/compat stay 1-bit: the serve tier's python
        // subscriber and the reference protocol don't speak sign2), and
        // only toward a peer that advertised decode capability.
        if (slot && lk2.peer_sign2 &&
            (e->prec_mode == 2 || (e->prec_mode == 1 && lk2.prec == 2)))
          mprec = 2;
        size_t fb = mprec == 2 ? per + (size_t)e->W * 4 : per;
        int bmax = sub && e->burst > kSubBurstCap ? kSubBurstCap : e->burst;
        if (mprec == 2) {
          // a sign2 burst is ~2x the bytes per frame: cap it so the
          // message still fits every peer's receive bound (r11
          // wire.frame_wire_bytes sized recv_cap for it)
          int64_t cap2 =
              ((int64_t)e->recv_cap - (int64_t)kHdrV3) / (int64_t)fb;
          if (cap2 < 1) cap2 = 1;
          if (bmax > cap2) bmax = (int)cap2;
        }
        if (slot) {
          // r11 cascade quantize: up to e->cascade halving frames per
          // MEMORY PASS (stcodec.c's r11 section). Frame 0's scales are
          // measured from the partials as before; frames 1..k-1 take the
          // halving schedule the measured sequence converges to anyway.
          // Scales ride the wire, so the receiver is oblivious; the
          // residual's drain per message gets DEEPER (bound ~s/2^(k-1))
          // while the sender's passes per message drop ~k-fold — the
          // pass count, not bandwidth, was the measured 1 Mi wall.
          int64_t wstride = (int64_t)(fb / 4);
          int kcmax = e->cascade < 1 ? 1 : (e->cascade > 64 ? 64 : e->cascade);
          while (msg.nframes < bmax) {
            scales_from_partials(e, amax, ss, sabs, scales.data());
            if (!any_nonzero(scales.data(), e->L)) {
              if (msg.nframes == 0) lk2.dirty = false;  // nothing to say
              break;
            }
            // Cascade schedule: per leaf, a pow2 ladder from the
            // residual's AMAX down to the policy (rms) scale. Anchoring
            // the top at amax (not rms) is what makes the drain
            // geometric for the WHOLE population: each |r| <= bound
            // level halves the bound, outliers included — an rms-anchored
            // ladder starves the gaussian tail (outliers move one
            // ever-shrinking +-s per frame; measured: amax decays
            // linearly and a full drain never terminates), while the
            // policy's own per-frame schedule has exactly the same tail
            // (it is the known slow-gaussian-tail regime). The depth
            // collapses to 1 on its own when pow2(amax) == policy scale
            // — the lockstep drain-tail states — and a single measured
            // frame then merges phase groups and terminates the drain
            // exactly (scale reads 0, link goes idle), the production
            // endgame. Measured on a 64 Ki gaussian: exact drain in 44
            // frames / 24 passes vs NO termination in 20 k frames for
            // the per-frame schedule. sign2's magnitude bit reaches 3s,
            // so its ladder starts two binades lower at equal coverage.
            int kc = 1;
            if (kcmax > 1) {
              int maxd = 1;
              for (int64_t i = 0; i < e->L; i++) {
                if (scales.data()[i] <= 0.0f) continue;
                union {
                  float f;
                  uint32_t u;
                } b;
                b.f = (float)amax[i];
                b.u &= 0x7F800000u;  // pow2 floor; subnormals -> 0
                float st = b.f;
                if (mprec == 2) st *= 0.25f;  // +-3s covers the top levels
                if (st <= scales.data()[i]) continue;
                int d = ilogbf(st) - ilogbf(scales.data()[i]) + 1;
                if (d > maxd) maxd = d;
              }
              // Dense states extend the ladder BELOW the rms anchor: the
              // extra refinement levels are nearly free in the same pass
              // and leave a cleaner (finer-lattice) residual, which the
              // endgame then merges in FEWER single-frame passes — the
              // measured 64 Ki gaussian drain goes 44 frames / 24 passes
              // (extra 0) -> 33 / 4 (extra 8), still terminating exactly.
              if (maxd > 1) maxd += 8;
              kc = maxd < kcmax ? maxd : kcmax;
            }
            if (kc > bmax - msg.nframes) kc = bmax - msg.nframes;
            int kreal = 0;
            for (int j = 0; j < kc; j++) {
              float* row = sched.data() + (size_t)j * e->L;
              if (j == 0) {
                if (kc == 1) {
                  // single measured frame: exactly the policy schedule
                  std::memcpy(row, scales.data(), (size_t)e->L * 4);
                } else {
                  for (int64_t i = 0; i < e->L; i++) {
                    float s = scales.data()[i];
                    if (s > 0.0f) {
                      union {
                        float f;
                        uint32_t u;
                      } b;
                      b.f = (float)amax[i];
                      b.u &= 0x7F800000u;
                      float st = b.f;
                      if (mprec == 2) st *= 0.25f;
                      if (st > s) s = st;  // ladder top (>= policy scale)
                    }
                    row[i] = s;
                  }
                }
              } else {
                const float* prev = sched.data() + (size_t)(j - 1) * e->L;
                for (int64_t i = 0; i < e->L; i++) row[i] = prev[i] * 0.5f;
                // the halving hit the denormal floor: an all-zero-scale
                // frame would count nowhere at the receiver (taxonomy)
                if (!any_nonzero(row, e->L)) break;
              }
              std::memcpy(body + (size_t)(msg.nframes + j) * fb, row,
                          (size_t)e->L * 4);
              kreal++;
            }
            uint8_t* f0 = body + (size_t)msg.nframes * fb;
            uint32_t* wbase = (uint32_t*)(f0 + (size_t)e->L * 4);
            if (mprec == 2)
              stc_quantize2_ef_cascade(
                  lk2.resid.data(), lk2.resid.data(), e->off.data(),
                  e->ns.data(), e->padded.data(), e->L, kreal, sched.data(),
                  wbase, wstride, e->W, amax.data(), ss.data(), sabs.data());
            else
              stc_quantize_ef_cascade(
                  lk2.resid.data(), lk2.resid.data(), e->off.data(),
                  e->ns.data(), e->padded.data(), e->L, kreal, sched.data(),
                  wbase, wstride, amax.data(), ss.data(), sabs.data());
            msg.nframes += kreal;
            if (kreal < kc) break;  // schedule floored mid-cascade
          }
        } else {
          for (int b = 0; b < bmax; b++) {
            scales_from_partials(e, amax, ss, sabs, scales.data());
            if (!any_nonzero(scales.data(), e->L)) {
              if (b == 0) lk2.dirty = false;  // nothing to say at all
              break;
            }
            size_t base_s = msg.scales.size(), base_w = msg.words.size();
            msg.scales.resize(base_s + (size_t)e->L);
            msg.words.resize(base_w + (size_t)e->W);
            float* fscales = msg.scales.data() + base_s;
            uint32_t* fwords = msg.words.data() + base_w;
            std::memcpy(fscales, scales.data(), (size_t)e->L * 4);
            stc_quantize_ef_partials(lk2.resid.data(), lk2.resid.data(),
                                     e->off.data(), e->ns.data(),
                                     e->padded.data(), e->L, scales.data(),
                                     fwords, amax.data(), ss.data(),
                                     sabs.data());
            msg.nframes++;
          }
        }
        // amax/ss/sabs now hold the post-quantize residual's partials
        // (whether any frame was emitted or not): seed the cache for the
        // next message.
        std::copy(amax.begin(), amax.end(), lk2.pamax.begin());
        std::copy(ss.begin(), ss.end(), lk2.pss.begin());
        std::copy(sabs.begin(), sabs.end(), lk2.psabs.begin());
        lk2.pvalid = true;
        if (msg.nframes == 0) {
          if (slot) e->txpool.unref(slot);
          continue;
        }
        e->frames_out += (uint64_t)msg.nframes;
        if (mprec == 2) e->frames2_out += (uint64_t)msg.nframes;
        msg.prec = (uint8_t)mprec;
        if (sub) {
          // unledgered: allocate wire seqs (the subscriber's gap detector
          // needs them) and capture the trace stamp; no unacked entry —
          // delivery degrades to ack-on-send like compat, and loss is the
          // subscriber's resync to repair
          int nmsg = sub_ranged ? msg.nframes : 1;
          msg.seq = lk2.tx_seq + 1;
          lk2.tx_seq += (uint64_t)nmsg;
          if (e->trace_wire) {
            tr_o = e->t_has ? e->t_origin : e->obs_id;
            tr_g = e->t_has ? e->t_gen : st_obs_now_ns();
            tr_h = e->t_has ? (uint8_t)(e->t_hops > 255 ? 255 : e->t_hops) : 0;
          }
        }
        // ledger entry BEFORE the send: the receiver's ACK must never race
        // ahead of the entry it acknowledges (comm/peer.py _send_loop).
        // Compat: no ACKs exist, so no ledger — delivery degrades to
        // ack-on-send like the Python compat tier (peer.py _send_loop
        // docstring); a failed send rolls back THIS message inline below.
        if (!e->compat_bytes && !sub) {
          msg.seq = ++lk2.tx_seq;
          // wire header, packed flush against the 8-aligned body at
          // kBodyOff (comm/wire.py framing; LE host assumed): BURST
          // [kind][u32 seq][u8 k], DATA [kind][u32 seq], each followed by
          // the 13-byte r09 trace context when trace_wire is on.
          uint32_t seq32 = (uint32_t)msg.seq;
          // r14: aligned v3 toward peers that advertised the capability
          // (24-byte header; trace context is a fixed field, so v3 also
          // requires trace emission — the ST_WIRE_TRACE=0 pin keeps v1)
          const bool v3 = lk2.wire_v3 && e->trace_wire;
          size_t hdr = v3 ? kHdrV3
                          : (e->burst > 1
                                 ? (e->trace_wire ? kBurstHdrV2 : kBurstHdrV1)
                                 : (e->trace_wire ? kDataHdrV2 : kDataHdrV1));
          slot->wire_off = (uint32_t)(kBodyOff - hdr);
          uint8_t* H = slot->buf.data() + slot->wire_off;
          size_t o;
          // r11: the kind byte's top bit marks sign2 frame bodies (see
          // kPrecBit) — set only toward peers that advertised the decode
          uint8_t pbit = mprec == 2 ? kPrecBit : 0;
          if (v3) {
            std::memset(H, 0, kHdrV3);
            H[0] = (e->burst > 1 ? kBurst : kData) | pbit;
            H[1] = (uint8_t)msg.nframes;
            std::memcpy(H + 4, &seq32, 4);
            uint32_t to = e->t_has ? e->t_origin : e->obs_id;
            uint64_t tg = e->t_has ? e->t_gen : st_obs_now_ns();
            uint8_t th =
                e->t_has ? (uint8_t)(e->t_hops > 255 ? 255 : e->t_hops) : 0;
            std::memcpy(H + 8, &to, 4);
            std::memcpy(H + 12, &tg, 8);
            H[20] = th;
          } else {
          if (e->burst > 1) {
            H[0] = kBurst | pbit;
            std::memcpy(H + 1, &seq32, 4);
            H[5] = (uint8_t)msg.nframes;
            o = kBurstHdrV1;
          } else {
            H[0] = kData | pbit;
            std::memcpy(H + 1, &seq32, 4);
            o = kDataHdrV1;
          }
          if (e->trace_wire) {
            // pending stamp, read under e->mu (we hold it here). A node
            // that never added nor applied anything traced stamps itself
            // at hop 0 — e.g. the join-seed diff residual.
            uint32_t to = e->t_has ? e->t_origin : e->obs_id;
            uint64_t tg = e->t_has ? e->t_gen : st_obs_now_ns();
            uint8_t th =
                e->t_has ? (uint8_t)(e->t_hops > 255 ? 255 : e->t_hops) : 0;
            std::memcpy(H + o, &to, 4);
            std::memcpy(H + o + 4, &tg, 8);
            H[o + 12] = th;
          }
          }
          slot->wire_len =
              (uint32_t)(hdr + (size_t)msg.nframes * fb);
          msg.slot = slot;  // the ledger entry owns the acquire reference
          msg.sent_at = EClock::now();
          if (lk2.unacked.empty()) lk2.ack_progress = msg.sent_at;
          it->second.unacked.push_back(msg);
          // in-flight reference for the send below, taken UNDER e->mu:
          // after the lock drops, a concurrent detach/stash_carry can
          // rollback_unacked and drop the ledger reference — taken
          // outside the lock, the slot could hit zero refs and be
          // recycled before our send even starts (use-after-free read +
          // a double free-list push). retransmit_pass refs under the
          // lock for the same reason.
          slot->refs.fetch_add(1, std::memory_order_relaxed);
        }
      }
      // r10 subscriber links: encode + send outside the lock, unledgered.
      // Ranged: one kRData message per frame ([kind][seq][wlo][wcnt]
      // [trace?][scales][word slice]) — the subscriber receives and
      // buffers ONLY its pages. Full-table: one ordinary DATA/BURST
      // message (the subscriber speaks the normal framing, just without
      // ACKing it). Frame buffers live in msg.scales/words (transient —
      // nothing to retransmit, by design).
      if (sub) {
        st_fault_crash_point("mid-burst");
        const size_t L4 = (size_t)e->L * 4;
        bool ok = true;
        if (sub_ranged) {
          const size_t hdr = e->trace_wire ? 26 : 13;
          payload.resize(hdr + L4 + (size_t)sub_wcnt * 4);
          for (int32_t f = 0; f < msg.nframes && ok; f++) {
            uint8_t* p = payload.data();
            p[0] = kRData;
            uint32_t s32 = (uint32_t)(msg.seq + (uint64_t)f);
            uint32_t lo32 = (uint32_t)sub_wlo, c32 = (uint32_t)sub_wcnt;
            std::memcpy(p + 1, &s32, 4);
            std::memcpy(p + 5, &lo32, 4);
            std::memcpy(p + 9, &c32, 4);
            size_t o = 13;
            if (e->trace_wire) {
              std::memcpy(p + o, &tr_o, 4);
              std::memcpy(p + o + 4, &tr_g, 8);
              p[o + 12] = tr_h;
              o += 13;
            }
            std::memcpy(p + o, msg.scales.data() + (size_t)f * e->L, L4);
            std::memcpy(p + o + L4,
                        msg.words.data() + (size_t)f * e->W + sub_wlo,
                        (size_t)sub_wcnt * 4);
            ok = sub_send(e, id, payload.data(), payload.size());
            if (ok) e->sub_msgs_out++;
          }
        } else {
          const size_t per2 = L4 + (size_t)e->W * 4;
          const bool burst = msg.nframes > 1;
          const size_t hdr =
              burst ? (e->trace_wire ? kBurstHdrV2 : kBurstHdrV1)
                    : (e->trace_wire ? kDataHdrV2 : kDataHdrV1);
          payload.resize(hdr + (size_t)msg.nframes * per2);
          uint8_t* p = payload.data();
          uint32_t s32 = (uint32_t)msg.seq;
          size_t o;
          if (burst) {
            p[0] = kBurst;
            std::memcpy(p + 1, &s32, 4);
            p[5] = (uint8_t)msg.nframes;
            o = kBurstHdrV1;
          } else {
            p[0] = kData;
            std::memcpy(p + 1, &s32, 4);
            o = kDataHdrV1;
          }
          if (e->trace_wire) {
            std::memcpy(p + o, &tr_o, 4);
            std::memcpy(p + o + 4, &tr_g, 8);
            p[o + 12] = tr_h;
            o += 13;
          }
          for (int32_t f = 0; f < msg.nframes; f++) {
            std::memcpy(p + o, msg.scales.data() + (size_t)f * e->L, L4);
            std::memcpy(p + o + L4, msg.words.data() + (size_t)f * e->W,
                        (size_t)e->W * 4);
            o += per2;
          }
          ok = sub_send(e, id, payload.data(), payload.size());
          if (ok) e->sub_msgs_out++;
        }
        if (ok) {
          sent_any = true;
        } else {
          // undelivered: roll this message's frames back so a detach
          // returns the residual the subscriber is still owed, and mark
          // the link dead (membership is Python's call, as everywhere)
          StLockGuard lk(e->mu);
          auto it = e->links.find(id);
          if (it != e->links.end()) {
            for (int32_t f = 0; f < msg.nframes; f++)
              stc_apply_frame(it->second.resid.data(),
                              it->second.resid.data(), e->off.data(),
                              e->ns.data(), e->padded.data(), e->L,
                              msg.scales.data() + (size_t)f * e->L,
                              msg.words.data() + (size_t)f * e->W);
            it->second.pvalid = false;
            it->second.dead = true;
          }
        }
        continue;
      }
      // send outside the lock
      if (e->compat_bytes) {
        // reference raw frames, nframes of them back-to-back (see the
        // compat-burst note in st_engine_create): each is
        // [f32 scale][ceil(n/8) mask bytes]; L == 1 (the peer rejects
        // multi-leaf tables in compat mode) and ceil(n/8) <= W*4, so the
        // words buffer always covers each mask
        payload.resize((size_t)msg.nframes * e->compat_bytes);
        for (int32_t f = 0; f < msg.nframes; f++) {
          uint8_t* p = payload.data() + (size_t)f * e->compat_bytes;
          std::memcpy(p, msg.scales.data() + (size_t)f * e->L, 4);
          std::memcpy(p + 4, msg.words.data() + (size_t)f * e->W,
                      (size_t)e->compat_bytes - 4);
        }
      }
      // crash point: frames quantized + error feedback applied + ledger
      // entry pushed, message NOT yet on the wire — death here must roll
      // the whole burst into the re-graft carry on restart
      st_fault_crash_point("mid-burst");
      bool delivered = false;
      int32_t fails = 0, bounces = 0;
      // (the in-flight slot reference for this send was taken under e->mu
      // at ledger-push time — see above)
      while (!e->stop.load()) {
        int32_t r =
            slot ? st_node_send_zc(e->node, id,
                                   slot->buf.data() + slot->wire_off,
                                   (int32_t)slot->wire_len, 0.1,
                                   tx_slot_release, slot)
                 : st_node_send(e->node, id, payload.data(),
                                (int32_t)payload.size(), 0.1);
        if (r == 1) {
          delivered = true;
          break;
        }
        if (r < 0) break;  // dead link
        bounces++;  // sat out the full timeout on a full sendq
        if (e->quarantine > 0 && ++fails >= e->quarantine) {
          // quarantine: tear the stalled link down; the failed-send
          // rollback below + Python's LINK_DOWN -> carry -> re-graft
          // recover every undelivered frame
          st_obs_emit(e->obs_id, kEvQuarantine, id, (uint64_t)fails);
          st_node_drop_link(e->node, id);
          break;
        }
      }
      if (slot && !delivered)
        e->txpool.unref(slot);  // transport took no ownership
      if (bounces > 0 && e->prec_mode == 1) {
        // byte backpressure observed: feed the precision governor's
        // byte-bound gate (harvested at its next beat)
        StLockGuard lk(e->mu);
        auto it = e->links.find(id);
        if (it != e->links.end()) it->second.gov_bp += (uint32_t)bounces;
      }
      if (delivered) {
        // compat: every frame IS a protocol message (the reference wire has
        // no message framing beyond the fixed frame size), keeping the
        // taxonomy's msgs == frames on both ends of a compat link
        e->msgs_out += e->compat_bytes ? (uint64_t)msg.nframes : 1;
        sent_any = true;
      } else {
        // undelivered: roll ALL outstanding feedback back so a re-graft
        // owes the full residual (peer.py nack path on send failure).
        // Compat has no ledger — roll back this message's own frames
        // directly (stronger than the reference, which loses them).
        StLockGuard lk(e->mu);
        auto it = e->links.find(id);
        if (it != e->links.end()) {
          if (e->compat_bytes) {
            for (int32_t f = 0; f < msg.nframes; f++)
              stc_apply_frame(it->second.resid.data(),
                              it->second.resid.data(), e->off.data(),
                              e->ns.data(), e->padded.data(), e->L,
                              msg.scales.data() + (size_t)f * e->L,
                              msg.words.data() + (size_t)f * e->W);
            it->second.pvalid = false;  // inline rollback bypasses the cache
          } else {
            rollback_unacked(e, it->second, &it->second.rolled);
          }
          it->second.dead = true;
        }
      }
    }
    // go-back-N delivery timer: retransmit stranded unacked tails (and
    // tear down black-hole links) — runs every pass, dirty links or not
    if (!e->compat_bytes && e->ack_timeout > 0 && !e->stop.load())
      retransmit_pass(e, ids);
    if (!sent_any && !e->stop.load()) {
      // explicit wait loop (not wait_for-with-predicate): the predicate
      // lambda would read the wmu-guarded wseq from a context the
      // thread-safety analysis treats as lock-free
      StUniqueLock lk(e->wmu);
      auto nap_deadline = st_cv_deadline(0.05);
      while (e->wseq <= seq_before && !e->stop.load()) {
        if (e->wcv.wait_until(lk.native(), nap_deadline) ==
            std::cv_status::timeout)
          break;
      }
    }
  }
}

// ---- receiver -------------------------------------------------------------

void flush_acks(Engine* e, int32_t id, ELink& lk) ST_REQUIRES(e->mu) {
  // cumulative + retried (a backpressure-dropped ACK must be re-offered or
  // the sender's ledger never drains — comm/peer.py _flush_acks)
  if (e->compat_bytes) return;  // the reference protocol has no ACKs
  if (lk.rx_count <= lk.ack_sent || lk.dead) return;
  uint8_t ack[9];
  ack[0] = kAck;
  uint64_t c = lk.rx_count;
  std::memcpy(ack + 1, &c, 8);  // little-endian host assumed (x86/arm64-le)
  int32_t r = st_node_send(e->node, id, ack, 9, 0.0);
  if (r == 1 || r < 0) lk.ack_sent = lk.rx_count;
}

void receiver_loop(Engine* e) {
  // batch accumulators (frames from one link applied in one pass)
  std::vector<float> bscales;
  std::vector<uint32_t> bwords;
  size_t per = frame_bytes(e);
  while (!e->stop.load()) {
    uint64_t seq0 = st_node_data_seq(e->node);
    bool busy = false;
    std::vector<int32_t> ids;
    {
      StLockGuard lk(e->mu);
      for (auto& kv : e->links)
        if (!kv.second.dead) ids.push_back(kv.first);
    }
    // r09 trace bookkeeping is part of the obs subsystem's toggleable cost
    // (the overhead bench's paired A/B flips this flag): when off, traced
    // headers are still parsed for framing but no clock reads / atomics /
    // events happen per message.
    bool obs_on = st_obs_is_enabled() != 0;
    for (int32_t id : ids) {
      int32_t batchk = 0;
      int batch_prec = 1;  // r11: a batch is precision-homogeneous
      // r14 zero-repack path: a v3 message pending direct-from-wire apply
      // (the pointers borrow the current recv_zc loan, so it flushes
      // before the next pop)
      const uint8_t* wire_body = nullptr;
      int32_t wire_k = 0;
      int wire_prec = 1;
      size_t wire_stride = 0;
      uint64_t msgs = 0;
      // last traced stamp accepted in this batch (+ per-batch aggregates):
      // folded into the engine's pending stamp and the link's staleness
      // gauge at flush, under e->mu
      bool have_trace = false;
      uint32_t tr_origin = 0, tr_hops = 0;
      uint64_t tr_gen = 0;
      uint64_t n_traced = 0, hops_acc = 0;
      // last in-order wire seq accepted on this link (go-back-N; only this
      // thread advances rx_count, so the snapshot stays valid across the
      // batch — msgs tracks acceptances not yet folded in by flush)
      uint64_t rx_base = 0;
      {
        StLockGuard lk(e->mu);
        auto it = e->links.find(id);
        if (it != e->links.end()) rx_base = it->second.rx_count;
      }
      bscales.clear();
      bwords.clear();
      auto flush = [&]() {
        if (batchk == 0 && msgs == 0 && wire_k == 0) return;
        StLockGuard lk(e->mu);
        auto it = e->links.find(id);
        if (it == e->links.end()) return;
        if (batchk > 0) {
          apply_batch(e, id, batchk, bscales.data(), bwords.data(),
                      batch_prec);
        }
        if (wire_k > 0) {
          apply_batch_wire(e, id, wire_k, wire_body, wire_stride, wire_prec);
          wire_k = 0;
          wire_body = nullptr;
        }
        if (have_trace) {
          // advance the pending stamp: this node is now one hop further
          // from the origin than the message that carried it
          uint32_t hop = tr_hops + 1;
          e->t_origin = tr_origin;
          e->t_gen = tr_gen;
          e->t_hops = hop;
          e->t_has = true;
          if (obs_on) {
            uint64_t now = st_obs_now_ns();
            uint64_t age = now > tr_gen ? now - tr_gen : 0;
            it->second.stale_ns = age;
            it->second.last_hops = hop;
            e->staleness_ns_last.store(age, std::memory_order_relaxed);
            e->hops_sum += hops_acc;
            e->hops_msgs += n_traced;
            e->traced_msgs_in += n_traced;
          }
          have_trace = false;
          n_traced = 0;
          hops_acc = 0;
        }
        // crash point: applied + flooded, ACK not yet sent — the sender
        // still ledgers these messages and re-delivers (at-least-once)
        if (msgs > 0) st_fault_crash_point("between-apply-and-ack");
        it->second.rx_count += msgs;
        e->msgs_in += msgs;
        rx_base += msgs;
        flush_acks(e, id, it->second);
        batchk = 0;
        msgs = 0;
        bscales.clear();
        bwords.clear();
      };
      for (int iter = 0; iter < 256; iter++) {  // bounded: don't starve links
        // r11: also bound the batch by FRAMES. flush() applies the whole
        // batch in one fused pass under e->mu and only THEN acks — at
        // saturation (256 messages x a ~31-frame burst each) that single
        // flush runs for whole seconds, the peer's send window (32 msgs)
        // stays exhausted the entire time, and the stream freezes into a
        // stop-and-go duty cycle paced by our flush latency. 256 frames
        // keeps the fused pass in the tens-of-ms class (both precisions)
        // so the cumulative ACK advances continuously and the sender's
        // window never starves; the table read still amortizes across
        // the full batch.
        if (batchk >= 256) break;
        // r14: zero-copy pop — `buf` borrows the transport's rx buffer
        // until the next recv_zc/recv_done on this link; everything this
        // iteration needs is either parsed or copied (batch vectors,
        // ctrl queue) before the next pop releases it
        const uint8_t* buf = nullptr;
        int32_t n = st_node_recv_zc(e->node, id, &buf, 0.0);
        if (n == 0) break;
        if (n < 0) {
          // dead + drained; rollback happens at detach (or the sender's
          // failed send) — membership/carry is Python's call
          StLockGuard lk(e->mu);
          auto it = e->links.find(id);
          if (it != e->links.end()) it->second.dead = true;
          break;
        }
        busy = true;
        if (e->compat_bytes) {
          // raw reference frame: [f32 scale][mask bytes], fixed size (the
          // transport's compat framing delivers whole frames only).
          // scale == 0 is the reference's idle keepalive (quirk Q2) and
          // non-finite is corruption (quirk Q9) — both are no-ops that
          // count nowhere, keeping msgs == frames (the compat exception in
          // peer.metrics()'s taxonomy).
          if ((size_t)n != (size_t)e->compat_bytes || e->sealed.load())
            continue;
          float sc;
          std::memcpy(&sc, buf, 4);
          if (sc == 0.0f || !std::isfinite(sc)) continue;
          msgs++;
          size_t bs = bscales.size(), bw = bwords.size();
          bscales.resize(bs + (size_t)e->L);  // L == 1 in compat
          bwords.resize(bw + (size_t)e->W, 0u);
          bscales[bs] = sc;
          std::memcpy(bwords.data() + bw, buf + 4,
                      (size_t)e->compat_bytes - 4);
          batchk++;
          continue;
        }
        uint8_t kind = buf[0];
        // r11 precision bit: data kinds may carry kPrecBit marking sign2
        // (2-bit) frame bodies — decoded unconditionally (tolerant decode;
        // EMISSION is what capability-gates). Any other kind with the top
        // bit set stays an unknown control message.
        int p2 = 0;
        if ((kind & kPrecBit) &&
            ((kind & ~kPrecBit) == kData || (kind & ~kPrecBit) == kBurst)) {
          p2 = 1;
          kind &= ~kPrecBit;
        }
        if (kind == kData || kind == kBurst) {
          if (e->sealed.load()) continue;  // leaving: sender re-delivers
          // Go-back-N acceptance (comm/wire.py tx_seq): only the next
          // in-order, DECODABLE message is applied and counted. A
          // duplicate (seq <= rx: injected, or a retransmit racing our
          // ACK) and anything after a gap (seq > rx+1: a message vanished
          // at the wire) are discarded unapplied; an undecodable message
          // (truncated/garbled) likewise does NOT consume its seq — the
          // sender's retransmission re-delivers it whole, and our
          // cumulative ACK is always exactly the last accepted seq.
          if (n < 5) continue;  // too short to carry a seq: undecodable
          // v1/v2/v3 framing by exact length (per_rx is a multiple of 4;
          // 5/18 for kData, 6/19 for kBurst, 24 for v3 — all distinct
          // mod 4, so the sizes can never coincide): any sender's
          // messages keep applying on any node (the version gates are
          // about what we EMIT). The r11 precision bit selects the frame
          // width FIRST (per vs per+4W), so the discriminations compose.
          // v3 must be detected BEFORE the seq check — its seq field
          // lives at byte 4, not 1.
          size_t per_rx = p2 ? per + (size_t)e->W * 4 : per;
          const bool v3 = (size_t)n >= kHdrV3 && buf[1] > 0 &&
                          (size_t)n == kHdrV3 + (size_t)buf[1] * per_rx;
          uint32_t seq;
          std::memcpy(&seq, buf + (v3 ? 4 : 1), 4);
          if (seq != (uint32_t)(rx_base + msgs + 1)) {  // dup/gap: discard
            e->dedup_discards++;
            st_obs_emit(e->obs_id, kEvDedupDiscard, id, (uint64_t)seq);
            continue;
          }
          int32_t k = 0;
          const uint8_t* p = nullptr;
          const uint8_t* trace = nullptr;  // 13-byte context, if present
          if (v3) {
            k = buf[1];
            trace = buf + 8;  // [origin u32][gen u64][hops u8], v2 order
            p = buf + kHdrV3;
          } else if (kind == kData && (size_t)n == kDataHdrV1 + per_rx) {
            k = 1;
            p = buf + kDataHdrV1;
          } else if (kind == kData && (size_t)n == kDataHdrV2 + per_rx) {
            k = 1;
            trace = buf + kDataHdrV1;
            p = buf + kDataHdrV2;
          } else if (kind == kBurst && n >= 6 && buf[5] > 0 &&
                     (size_t)n == kBurstHdrV1 + (size_t)buf[5] * per_rx) {
            k = buf[5];
            p = buf + kBurstHdrV1;
          } else if (kind == kBurst && n >= 19 && buf[5] > 0 &&
                     (size_t)n == kBurstHdrV2 + (size_t)buf[5] * per_rx) {
            k = buf[5];
            trace = buf + kBurstHdrV1;
            p = buf + kBurstHdrV2;
          } else {
            continue;  // undecodable: seq not consumed, await retransmit
          }
          // r14 zero-repack routing: the direct-from-wire apply flushes
          // PER MESSAGE (its pointers borrow the recv_zc loan), which
          // forfeits the cross-message batch amortization — a pure loss
          // on small tables where the per-pass table walk is cheap and
          // clumped messages are common. Route v3 messages to the direct
          // path only when the repack copy it deletes is the bigger cost
          // (>= 1 MiB of wire body); below that they join the ordinary
          // batch, whose per-frame parse handles the v3 body layout
          // identically (p already points past the 24-byte header).
          const bool direct =
              v3 && (size_t)k * per_rx >= (size_t)(1 << 20);
          // a precision change flushes the pending batch (apply_batch is
          // homogeneous); rx_base tracking spans the flush safely
          if (batchk > 0 && (direct || batch_prec != (p2 ? 2 : 1))) flush();
          batch_prec = p2 ? 2 : 1;
          msgs++;
          if (trace) {
            std::memcpy(&tr_origin, trace, 4);
            std::memcpy(&tr_gen, trace + 4, 8);
            tr_hops = trace[12];
            have_trace = true;
            if (obs_on) {
              uint32_t hop = tr_hops + 1;
              n_traced++;
              hops_acc += hop;
              // one record per accepted traced message: node/link say who
              // applied it, arg carries the generation (origin ns), extra
              // packs (origin id << 8 | hop) — the flight recorder
              // reconstructs the full causal path from these
              // (obs/trace_export.py trace_paths).
              st_obs_emit2(e->obs_id, kEvTraceApply, id, tr_gen,
                           (tr_origin << 8) | (hop > 255 ? 255 : hop));
            }
          }
          if (direct) {
            // r14 zero-repack apply: the 24-byte header 8-aligns the
            // body, so the fused kernels read scales/words straight from
            // the loaned wire buffer — no per-frame memcpy into batch
            // vectors at all. Sanitize non-finite scales IN PLACE first
            // (trust boundary; the loan is our own transport memory),
            // then flush immediately: the borrowed pointers must not
            // outlive this message's loan (released by the next pop).
            for (int32_t f = 0; f < k; f++) {
              float* s = const_cast<float*>(
                  reinterpret_cast<const float*>(p + (size_t)f * per_rx));
              for (int64_t i = 0; i < e->L; i++)
                if (!std::isfinite(s[i])) s[i] = 0.0f;
            }
            wire_body = p;
            wire_k = k;
            wire_prec = p2 ? 2 : 1;
            wire_stride = per_rx;
            flush();
            continue;
          }
          size_t wk = p2 ? (size_t)e->W * 2 : (size_t)e->W;  // words/frame
          for (int32_t f = 0; f < k; f++) {
            size_t bs = bscales.size(), bw = bwords.size();
            bscales.resize(bs + (size_t)e->L);
            bwords.resize(bw + wk);
            std::memcpy(bscales.data() + bs, p, (size_t)e->L * 4);
            p += (size_t)e->L * 4;
            std::memcpy(bwords.data() + bw, p, wk * 4);
            p += wk * 4;
            // trust boundary: non-finite scales become no-op leaves
            // (wire.decode_frame guard; quirk Q9's receive-path analog)
            for (int64_t i = 0; i < e->L; i++) {
              float* s = bscales.data() + bs + i;
              if (!std::isfinite(*s)) *s = 0.0f;
            }
            batchk++;
          }
        } else if (kind == kAck && n == 9) {
          uint64_t count;
          std::memcpy(&count, buf + 1, 8);
          StLockGuard lk(e->mu);
          auto it = e->links.find(id);
          if (it != e->links.end()) {
            ELink& lk2 = it->second;
            lk2.acked_cum = count;
            // cumulative ACK = last in-order wire seq the peer accepted;
            // every ledger entry at or below it is delivered — its tx slot
            // drops the ledger reference and returns to the ring once any
            // in-flight (re)send reference drains too
            bool progressed = false;
            auto ack_at = EClock::now();
            while (!lk2.unacked.empty() && lk2.unacked.front().seq <= count) {
              SentMsg& m = lk2.unacked.front();
              // delivery round trip: ledger append -> cumulative-ACK pop
              e->rtt_ns_total += (uint64_t)std::chrono::duration_cast<
                                     std::chrono::nanoseconds>(
                                     ack_at - m.sent_at)
                                     .count();
              e->rtt_msgs++;
              if (m.slot) e->txpool.unref(m.slot);
              lk2.unacked.pop_front();
              progressed = true;
            }
            if (progressed) {
              // delivery progressed: reset the go-back-N timer
              lk2.ack_progress = EClock::now();
              lk2.retx_rounds = 0;
            }
          }
        } else {
          // control-plane message (handshake retries, REJECT, unknown):
          // preserve ordering — flush data first — then hand to Python
          flush();
          StLockGuard lk(e->cmu);
          e->ctrl.emplace_back(
              id, std::vector<uint8_t>(buf, buf + n));
        }
      }
      bool applied = batchk > 0;
      flush();
      // the last loaned rx buffer is fully parsed/copied by now
      st_node_recv_done(e->node, id);
      {
        // retry any previously-backpressured ACK even on idle passes
        StLockGuard lk(e->mu);
        auto it = e->links.find(id);
        if (it != e->links.end()) flush_acks(e, id, it->second);
      }
      if (applied) e->wake();  // flood refilled other links' residuals
    }
    if (!busy && !e->stop.load()) {
      st_node_wait_data(e->node, seq0, 0.05);
    }
  }
}

// ---- r17 engine-tier shard data plane -------------------------------------
//
// The r16 shard FWD plane (shared_tensor_tpu/shard/node.py) ran entirely in
// Python — correctness-first, ~3 orders of interpreter cost per message
// above the classic plane's native engine. This section ports the HOT LOOP
// into the same machinery: outbox residuals quantize DIRECTLY into
// refcounted TxSlots as burst-packed FWD frames (error feedback per target
// shard, the successive-halving drain ladder per message), relays forward a
// FWD whose owner is downstream VERBATIM — the received buffer's ownership
// transfers via st_node_recv_take, only the per-link seq is re-stamped in
// place, and the same bytes enqueue zero-copy through st_node_send_zc
// (sendmmsg/shm-lane eligible) while serving as the go-back-N ledger entry
// — and the owner's (origin, fwd_seq) dedup + slice apply commit under ONE
// plane mutex, byte-compatible with the Python tier's dedup windows so
// checkpoints and mixed trees interop.
//
// The CONTROL plane stays in Python (claim/grant/handoff/arbitration/
// announces): every non-FWD/ACK message on a member link defers to the
// ctrl queue (st_shard_poll_ctrl), exactly the engine/peer.py split.
// Ownership/routing mutations arrive over the ABI (adopt/release/
// set_route/set_handoff), all under the same mutex as the data path.
//
// Parity discipline: slice_quantize/slice_apply mirror state.SliceCodec
// step for step (same f32 elementwise arithmetic, double accumulation for
// the scale reductions — state.py accumulates in f64 too, so POW2_RMS
// scales agree bit-for-bit in practice and scales always ride the wire).
// tests/test_shard_engine.py pins byte-equal frames/residuals/applies on
// shared random state via the exported st_slice_quantize/st_slice_apply.

constexpr uint8_t kFwd = 17;      // comm/wire.py FWD
constexpr size_t kFwdHdr = 21;    // [kind][seq u32][wlo u32][wcnt u32]
                                  // [origin u32][fwd_seq u32]
constexpr size_t kShardDedupWindow = 1024;  // shard/node.py DEDUP_WINDOW
constexpr int kOutboxMsgsPerPass = 4;  // shard/node.py OUTBOX_MSGS_PER_PASS
constexpr int32_t kCtrlHeadroom = 3;   // shard/node.py _queue_room keep
constexpr uint32_t kEvShardParkDrop = 36;  // obs/events.py CODE_NAMES
constexpr uint32_t kEvShardDedup = 37;

struct ShardSeg {
  int64_t g;       // global leaf index
  int64_t i0, i1;  // slice-element bounds of the segment
  int64_t n_live;  // non-padding elements in it
};

// Per-shard slice geometry, precomputed once at create (the shard ranges
// are fixed at creation — the r16 contract the python ShardMap carries).
struct ShardGeom {
  int64_t wlo = 0, wcnt = 0, elo = 0, n_el = 0;
  std::vector<ShardSeg> segs;
  std::vector<int32_t> leaf_of;  // slice element -> global leaf
  std::vector<float> live;       // 1.0 live / 0.0 padding
  int32_t kcap = 1;              // FWD frames per message (recv bound)
  // SYNTHETIC LAYOUT (r17): each segment presented as a leaf of a
  // slice-local table — live elements are a contiguous prefix of every
  // segment and segment bounds are 32-multiples, so the slice is a
  // legal stcodec layout and the hot loops ride the SAME AVX-512
  // cascade/apply kernels as the classic plane (stc_quantize_ef_cascade
  // / stc_apply_frames) instead of scalar twins.
  std::vector<int64_t> syn_off, syn_ns, syn_padded;
  std::vector<int32_t> syn_g;  // synthetic leaf -> global leaf
};

// One received FWD buffer whose ownership transferred from the transport
// (st_node_recv_take): refcounted like a TxSlot — the go-back-N ledger
// holds one reference, each in-flight (re)send another. The LAST unref
// returns the buffer to the transport's rx pool. `plane_live` lets
// st_shard_destroy wait for stragglers exactly like the TxPool drain.
struct ShardPlane;
struct TakenBuf {
  ShardPlane* plane = nullptr;
  void* tok = nullptr;
  uint8_t* data = nullptr;
  uint32_t len = 0;
  int32_t from_link = 0;
  std::atomic<int32_t> refs{0};
};

struct ShardSent {
  uint64_t seq = 0;
  TxSlot* slot = nullptr;    // originated / re-packed copy
  TakenBuf* taken = nullptr; // zero-copy relay
};

struct SMember {
  std::deque<ShardSent> unacked;
  uint64_t tx_seq = 0, rx_count = 0, ack_sent = 0;
  bool ack_due = false;
  EClock::time_point ack_progress{};
  int32_t retx_rounds = 0;
  bool window_blocked = false;
  bool dead = false;
  // per-link send-order mutex: the outbox pump (sender thread) and the
  // verbatim relay (receiver thread) both produce ledgered FWDs on the
  // same link — holding this across [seq alloc + ledger push + transport
  // enqueue] keeps wire order = seq order, which the python tier gets
  // for free from its single loop thread. Lock order: order_mu -> mu.
  std::shared_ptr<StMutex> order_mu = std::make_shared<StMutex>();
};

struct ParkedFwd {
  int32_t shard = 0;
  std::vector<uint8_t> bytes;
};

struct ShardPlane {
  void* node = nullptr;
  uint32_t obs_id = 0, origin = 0;
  int64_t L = 0, total = 0, total_n = 0, W = 0;
  std::vector<int64_t> off, ns, padded;
  int policy = kPow2Rms;
  int32_t recv_cap = 0;
  double ack_timeout = 0.0;
  int32_t ack_retry_limit = 8;
  int32_t park_cap = 4096;
  std::vector<ShardGeom> geom;  // n_shards entries, fixed at create

  TxPool txpool;

  StMutex mu;
  std::map<int32_t, std::vector<float>> owned ST_GUARDED_BY(mu);
  std::map<int32_t, std::vector<float>> outbox ST_GUARDED_BY(mu);
  std::set<int32_t> ho_sent ST_GUARDED_BY(mu);
  std::map<int32_t, SMember> members ST_GUARDED_BY(mu);
  std::map<int32_t, int32_t> route ST_GUARDED_BY(mu);
  int32_t uplink ST_GUARDED_BY(mu) = -1;
  uint32_t fwd_seq ST_GUARDED_BY(mu) = 0;
  // origin -> (seen set, insertion fifo): the end-to-end dedup window,
  // byte-compatible with shard/node.py's (DEDUP_WINDOW trim included)
  std::map<uint32_t, std::pair<std::set<uint32_t>, std::deque<uint32_t>>>
      dedup ST_GUARDED_BY(mu);
  std::deque<ParkedFwd> parked ST_GUARDED_BY(mu);

  // control messages (non FWD/ACK on member links) surfaced to Python
  StMutex cmu;
  std::deque<std::pair<int32_t, std::vector<uint8_t>>> ctrl
      ST_GUARDED_BY(cmu);

  // sender wake (missed-wakeup-safe sequence counter)
  StMutex wmu;
  std::condition_variable wcv;
  uint64_t wseq ST_GUARDED_BY(wmu) = 0;

  std::atomic<bool> stop{false};
  std::atomic<uint64_t> fwd_msgs_out{0}, fwd_msgs_in{0}, relayed{0};
  std::atomic<uint64_t> dedup_discards{0}, park_drops{0}, retx_msgs{0};
  std::atomic<uint64_t> updates{0}, fwd_frames_out{0}, fwd_frames_in{0};
  std::atomic<uint64_t> fwd_undecodable{0};
  std::atomic<int64_t> taken_live{0};
  std::thread send_thread, recv_thread;
  bool started = false;

  void wake() ST_EXCLUDES(wmu) {
    {
      StLockGuard lk(wmu);
      wseq++;
    }
    wcv.notify_all();
  }
};

void shard_geom_init(ShardPlane* p, const int64_t* wlo, const int64_t* wcnt,
                     int32_t n_shards) {
  // leaf boundaries: element index where each leaf's padded span ends
  std::vector<int64_t> bounds((size_t)p->L);
  int64_t acc = 0;
  for (int64_t i = 0; i < p->L; i++) {
    acc += p->padded[(size_t)i];
    bounds[(size_t)i] = acc;
  }
  p->geom.resize((size_t)n_shards);
  for (int32_t s = 0; s < n_shards; s++) {
    ShardGeom& g = p->geom[(size_t)s];
    g.wlo = wlo[s];
    g.wcnt = wcnt[s];
    g.elo = g.wlo * 32;
    g.n_el = g.wcnt * 32;
    g.leaf_of.resize((size_t)g.n_el);
    g.live.resize((size_t)g.n_el);
    int64_t leaf = 0;
    while (leaf < p->L && bounds[(size_t)leaf] <= g.elo) leaf++;
    for (int64_t j = 0; j < g.n_el; j++) {
      int64_t el = g.elo + j;
      while (leaf < p->L && bounds[(size_t)leaf] <= el) leaf++;
      int64_t lf = leaf < p->L ? leaf : p->L - 1;
      g.leaf_of[(size_t)j] = (int32_t)lf;
      g.live[(size_t)j] =
          (el - p->off[(size_t)lf]) < p->ns[(size_t)lf] ? 1.0f : 0.0f;
    }
    // contiguous runs of one leaf -> segments with live counts
    int64_t i0 = 0;
    while (i0 < g.n_el) {
      int64_t i1 = i0;
      int32_t lf = g.leaf_of[(size_t)i0];
      int64_t nl = 0;
      while (i1 < g.n_el && g.leaf_of[(size_t)i1] == lf) {
        if (g.live[(size_t)i1] != 0.0f) nl++;
        i1++;
      }
      g.segs.push_back(ShardSeg{lf, i0, i1, nl});
      g.syn_off.push_back(i0);
      g.syn_ns.push_back(nl);
      g.syn_padded.push_back(i1 - i0);
      g.syn_g.push_back(lf);
      i0 = i1;
    }
    size_t per = (size_t)p->L * 4 + (size_t)g.wcnt * 4;
    int64_t cap = ((int64_t)p->recv_cap - (int64_t)kFwdHdr) / (int64_t)per;
    if (cap < 1) cap = 1;
    if (cap > 255) cap = 255;
    g.kcap = (int32_t)cap;
  }
}

// The slice-codec hot loops below carry the plane's whole per-byte cost
// (quantize on the writer, apply at the owner): O3 + vectorization for
// just these bodies — exact float semantics, NO fast-math (the parity
// contract). Guarded off clang: the analyze gate runs -Werror and clang
// warns on gcc optimize pragmas it cannot honor.
#ifndef __clang__
#pragma GCC push_options
#pragma GCC optimize("O3,tree-vectorize")
#endif

// Per-segment scale measurement (state.SliceCodec.measure): scales per
// GLOBAL leaf (zero outside the range) + per-leaf amax. Reductions
// accumulate EXACT f64 products (f32->f64 squares are exact, so only the
// accumulation order is inexact) with 8 interleaved accumulators — a
// FIXED deterministic order; state.py's f64 numpy sum (pairwise) agrees
// with it to the last bit after the f32 cast in practice, which the
// parity test pins on shared random state.
//
// Layout note the speed leans on: within one leaf, LIVE elements are a
// contiguous prefix (padding sits at the leaf tail), so every segment
// splits into [live prefix | padding tail] and the per-element
// scale/live lookups collapse to constants per span.
void slice_measure(const ShardPlane* p, const ShardGeom& g,
                   const float* resid, float* scales, float* amaxes) {
  std::memset(scales, 0, (size_t)p->L * 4);
  std::memset(amaxes, 0, (size_t)p->L * 4);
  for (const ShardSeg& sg : g.segs) {
    if (sg.n_live <= 0) continue;
    int64_t live_end = sg.i0 + sg.n_live;
    // amax over the segment's elements (padding is 0 and cannot win; a
    // NaN element falls out of the comparisons here, and then poisons
    // the sum below into scales[g] = 0 — the same skipped segment
    // numpy's NaN-propagating max produces)
    float m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    int64_t j = sg.i0;
    for (; j + 4 <= sg.i1; j += 4) {
      float b0 = std::fabs(resid[j]), b1 = std::fabs(resid[j + 1]);
      float b2 = std::fabs(resid[j + 2]), b3 = std::fabs(resid[j + 3]);
      if (b0 > m0) m0 = b0;
      if (b1 > m1) m1 = b1;
      if (b2 > m2) m2 = b2;
      if (b3 > m3) m3 = b3;
    }
    for (; j < sg.i1; j++) {
      float a = std::fabs(resid[j]);
      if (a > m0) m0 = a;
    }
    float am = m0;
    if (m1 > am) am = m1;
    if (m2 > am) am = m2;
    if (m3 > am) am = m3;
    if (!(am > 0.0f) || !std::isfinite(am)) continue;
    amaxes[sg.g] = am;
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, a5 = 0, a6 = 0, a7 = 0;
    float s;
    if (p->policy == kAbsMean) {
      j = sg.i0;
      for (; j + 8 <= live_end; j += 8) {
        a0 += std::fabs((double)resid[j]);
        a1 += std::fabs((double)resid[j + 1]);
        a2 += std::fabs((double)resid[j + 2]);
        a3 += std::fabs((double)resid[j + 3]);
        a4 += std::fabs((double)resid[j + 4]);
        a5 += std::fabs((double)resid[j + 5]);
        a6 += std::fabs((double)resid[j + 6]);
        a7 += std::fabs((double)resid[j + 7]);
      }
      for (; j < live_end; j++) a0 += std::fabs((double)resid[j]);
      double acc = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
      s = (float)(acc / (double)(float)sg.n_live);
    } else {
      j = sg.i0;
      for (; j + 8 <= live_end; j += 8) {
        double d0 = resid[j], d1 = resid[j + 1];
        double d2 = resid[j + 2], d3 = resid[j + 3];
        double d4 = resid[j + 4], d5 = resid[j + 5];
        double d6 = resid[j + 6], d7 = resid[j + 7];
        a0 += d0 * d0;
        a1 += d1 * d1;
        a2 += d2 * d2;
        a3 += d3 * d3;
        a4 += d4 * d4;
        a5 += d5 * d5;
        a6 += d6 * d6;
        a7 += d7 * d7;
      }
      for (; j < live_end; j++) {
        double d = resid[j];
        a0 += d * d;
      }
      double acc = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
      s = (float)std::sqrt(acc / (double)(float)sg.n_live);
      if (p->policy == kPow2Rms) {
        union {
          float f;
          uint32_t u;
        } b;
        b.f = s;
        b.u &= 0x7F800000u;  // 2^floor(log2 s); subnormals -> 0
        s = b.f;
      }
    }
    scales[sg.g] = std::isfinite(s) ? s : 0.0f;
  }
}

// Pack + error-feedback one frame at a GIVEN scale row (the cascade
// rung) — state.SliceCodec.quantize_at. EF per segment with a constant
// scale over the live prefix (on the pre-subtraction sign), padding
// tail pinned to exactly 0 (the `new_r *= live` twin). The cold-path
// scalar twin of the stc cascade kernels the pump rides.
void slice_quantize_at(const ShardPlane* p, const ShardGeom& g,
                       float* resid, const float* row, uint32_t* words) {
  (void)p;
  // sign plane: bit j = (resid[j] <= 0) on LIVE lanes, 0 on padding —
  // the stcodec cascade-kernel convention (receivers mask by live)
  for (int64_t w = 0; w < g.wcnt; w++) {
    uint32_t bits = 0;
    const float* r = resid + w * 32;
    const float* lv = g.live.data() + w * 32;
    for (int b = 0; b < 32; b++)
      bits |= (uint32_t)(r[b] <= 0.0f && lv[b] != 0.0f) << b;
    words[w] = bits;
  }
  for (const ShardSeg& sg : g.segs) {
    float se = sg.n_live > 0 ? row[sg.g] : 0.0f;
    int64_t live_end = sg.i0 + sg.n_live;
    if (se > 0.0f) {
      for (int64_t k = sg.i0; k < live_end; k++) {
        float r0 = resid[k];
        resid[k] = r0 <= 0.0f ? r0 + se : r0 - se;
      }
    }
    for (int64_t k = live_end; k < sg.i1; k++) resid[k] = 0.0f;
  }
}

inline uint32_t f32_exp(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return (u >> 23) & 0xFFu;
}

bool slice_row_any(const ShardPlane* p, const float* row) {
  for (int64_t i = 0; i < p->L; i++)
    if (row[i] != 0.0f) return true;
  return false;
}

// Message-build scratch (one per sender thread / test call).
struct ShardScratch {
  std::vector<float> mscales, row, sched;
  std::vector<double> dpart;
};

// Build one FWD message's frames into `body` at wire strides (frame f's
// GLOBAL scale row at f*per, its word plane at f*per + 4L): ONE
// measurement (stc_scale_partials over the synthetic slice layout), the
// cascade-halving schedule (amax-anchored frame 0, +1 binade per rung to
// the measured scale, +8 refinement rungs — state.SliceCodec.cascade_rows
// bit-for-bit: the exponent math is integer), then every word plane in
// ONE memory pass via the classic plane's AVX-512 cascade kernel
// (stc_quantize_ef_cascade). Returns the frame count (0 = idle; the
// residual is then untouched). Error feedback lands in `resid` in place.
int slice_cascade_message(const ShardPlane* p, const ShardGeom& g,
                          float* resid, int kmax, uint8_t* body, size_t per,
                          ShardScratch& scr) {
  size_t nsyn = g.syn_g.size();
  if (scr.mscales.size() < nsyn) {
    scr.mscales.resize(nsyn);
    scr.row.resize(nsyn);
  }
  if (scr.dpart.size() < nsyn * 3) scr.dpart.resize(nsyn * 3);
  double* pa = scr.dpart.data();
  double* ps = pa + nsyn;
  double* pb = ps + nsyn;
  stc_scale_partials(resid, g.syn_off.data(), g.syn_ns.data(),
                     (int64_t)nsyn, pa, ps, pb);
  int d = 0;
  bool anyscale = false;
  for (size_t i = 0; i < nsyn; i++) {
    double n_live = (double)(float)g.syn_ns[i];
    float s = 0.0f;
    if (pa[i] > 0 && std::isfinite(pa[i]) && n_live > 0) {
      if (p->policy == kAbsMean) {
        s = (float)(pb[i] / n_live);
      } else {
        s = (float)std::sqrt(ps[i] / n_live);
        if (p->policy == kPow2Rms) {
          union {
            float f;
            uint32_t u;
          } b;
          b.f = s;
          b.u &= 0x7F800000u;
          s = b.f;
        }
      }
      if (!std::isfinite(s)) s = 0.0f;
    }
    scr.mscales[i] = s;
    if (s > 0.0f) {
      anyscale = true;
      union {
        float f;
        uint32_t u;
      } b;
      b.f = (float)pa[i];
      b.u &= 0x7F800000u;
      float top = b.f;
      int di = (int)f32_exp(top) - (int)f32_exp(s);
      if (di > d) d = di;
      scr.row[i] = top > s ? top : s;
    } else {
      scr.row[i] = 0.0f;
    }
  }
  if (!anyscale) return 0;
  int kc = d + 1 + (d > 0 ? 8 : 0);
  if (kc > kmax) kc = kmax;
  if (kc > 64) kc = 64;  // the cascade kernel's schedule cap
  if (kc < 1) kc = 1;
  if (scr.sched.size() < (size_t)kc * nsyn)
    scr.sched.resize((size_t)kc * nsyn);
  int nf = 0;
  for (int f = 0; f < kc; f++) {
    bool anyrow = false;
    for (size_t i = 0; i < nsyn; i++) {
      float v =
          f == 0 ? scr.row[i] : scr.sched[(size_t)(f - 1) * nsyn + i] * 0.5f;
      scr.sched[(size_t)f * nsyn + i] = v;
      if (v != 0.0f) anyrow = true;
    }
    if (f > 0 && !anyrow) break;  // halved into the subnormal floor
    nf++;
  }
  uint32_t* wbase = (uint32_t*)(body + (size_t)p->L * 4);
  stc_quantize_ef_cascade(resid, resid, g.syn_off.data(), g.syn_ns.data(),
                          g.syn_padded.data(), (int64_t)nsyn, nf,
                          scr.sched.data(), wbase, (int64_t)(per / 4), pa,
                          ps, pb);
  // scatter each rung's synthetic scales into the wire's GLOBAL per-leaf
  // rows (zero outside the slice's leaves)
  for (int f = 0; f < nf; f++) {
    float* sc = (float*)(body + (size_t)f * per);
    std::memset(sc, 0, (size_t)p->L * 4);
    for (size_t i = 0; i < nsyn; i++)
      sc[g.syn_g[i]] = scr.sched[(size_t)f * nsyn + i];
  }
  return nf;
}

// One measured single-frame step (state.SliceCodec.quantize — the
// serve-tier shape and the st_slice_quantize parity surface).
bool slice_quantize(const ShardPlane* p, const ShardGeom& g, float* resid,
                    float* scales, uint32_t* words) {
  std::vector<float> amaxes((size_t)p->L);
  slice_measure(p, g, resid, scales, amaxes.data());
  if (!slice_row_any(p, scales)) return false;
  slice_quantize_at(p, g, resid, scales, words);
  return true;
}

// Receiver step (state.SliceCodec.apply): target += scale[leaf]*(1-2*bit)
// on live lanes, saturated at +/-kSat. False for an all-zero-scale no-op.
// Same segment structure as the quantize: constant scale per live
// prefix; the padding tail only pays the clip (a no-op for the 0-valued
// padding an owned slice maintains — byte-identical to numpy's
// whole-slice np.clip).
bool slice_apply(const ShardPlane* p, const ShardGeom& g, float* target,
                 const float* scales, const uint32_t* words) {
  bool any = false;
  for (int64_t i = 0; i < p->L; i++)
    if (scales[i] != 0.0f) any = true;
  if (!any) return false;
  for (const ShardSeg& sg : g.segs) {
    float se = sg.n_live > 0 ? scales[sg.g] : 0.0f;
    int64_t live_end = sg.i0 + sg.n_live;
    for (int64_t j = sg.i0; j < live_end; j++) {
      float bf = (float)((words[j >> 5] >> (j & 31)) & 1u);
      float t = target[j] + se * (1.0f - 2.0f * bf);
      if (t > kSat) t = kSat;
      if (t < -kSat) t = -kSat;
      target[j] = t;
    }
    for (int64_t j = live_end; j < sg.i1; j++) {
      float t = target[j];
      if (t > kSat) t = kSat;
      if (t < -kSat) t = -kSat;
      target[j] = t;
    }
  }
  return true;
}

#ifndef __clang__
#pragma GCC pop_options
#endif

int32_t shard_of_word(const ShardPlane* p, uint32_t word_lo) {
  for (size_t s = 0; s < p->geom.size(); s++)
    if ((int64_t)word_lo >= p->geom[s].wlo &&
        (int64_t)word_lo < p->geom[s].wlo + p->geom[s].wcnt)
      return (int32_t)s;
  return -1;
}

void taken_unref(TakenBuf* t) {
  if (t->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    ShardPlane* p = t->plane;
    st_node_take_free(p->node, t->from_link, t->tok);
    delete t;
    p->taken_live.fetch_sub(1, std::memory_order_acq_rel);
  }
}

void taken_release(void* ctx) { taken_unref((TakenBuf*)ctx); }

void shard_entry_unref(ShardPlane* p, ShardSent& e) {
  if (e.slot) p->txpool.unref(e.slot);
  if (e.taken) taken_unref(e.taken);
  e.slot = nullptr;
  e.taken = nullptr;
}

// shard -> next-hop link (shard/node.py _next_hop): the learned route,
// else the uplink; never the arrival link, never a dead member. Caller
// holds p->mu.
int32_t shard_next_hop(ShardPlane* p, int32_t shard, int32_t arrival)
    ST_REQUIRES(p->mu) {
  auto rit = p->route.find(shard);
  if (rit != p->route.end() && rit->second != arrival) {
    auto mit = p->members.find(rit->second);
    if (mit != p->members.end() && !mit->second.dead) return rit->second;
  }
  if (p->uplink >= 0 && p->uplink != arrival) {
    auto mit = p->members.find(p->uplink);
    if (mit != p->members.end() && !mit->second.dead) return p->uplink;
  }
  return -1;
}

void shard_park(ShardPlane* p, int32_t shard, const uint8_t* data,
                uint32_t len) ST_REQUIRES(p->mu) {
  p->parked.push_back(ParkedFwd{shard, std::vector<uint8_t>(data, data + len)});
  while ((int32_t)p->parked.size() > p->park_cap) {
    p->parked.pop_front();
    // loud bounded loss, never unbounded memory (ShardConfig.park_cap)
    p->park_drops++;
    st_obs_emit(p->obs_id, kEvShardParkDrop, 0, 0);
  }
}

// Ledger + send one FWD on a member link, preserving per-link wire order
// across the two producing threads (see SMember::order_mu). The entry's
// bytes are re-stamped in place with the link's next seq. Consumes ONE
// owned reference of slot/taken on success (the ledger keeps it); takes
// its own in-flight reference for the transport enqueue. False = member
// gone/dead or go-back-N window full — ownership NOT consumed.
bool shard_ledger_send(ShardPlane* p, int32_t link, TxSlot* slot,
                       TakenBuf* taken, uint8_t* data, uint32_t len)
    ST_EXCLUDES(p->mu) {
  std::shared_ptr<StMutex> omu;
  {
    StLockGuard lk(p->mu);
    auto it = p->members.find(link);
    if (it == p->members.end() || it->second.dead) return false;
    omu = it->second.order_mu;
  }
  StLockGuard ol(*omu);
  {
    StLockGuard lk(p->mu);
    auto it = p->members.find(link);
    if (it == p->members.end() || it->second.dead) return false;
    SMember& m = it->second;
    if (m.unacked.size() >= kSendWindow) {
      if (!m.window_blocked) {
        m.window_blocked = true;
        st_obs_emit(p->obs_id, kEvWindowStall, link,
                    (uint64_t)m.unacked.size());
      }
      return false;
    }
    m.window_blocked = false;
    uint64_t seq = ++m.tx_seq;
    uint32_t s32 = (uint32_t)seq;
    std::memcpy(data + 1, &s32, 4);  // re-stamp ONLY the per-link seq
    if (m.unacked.empty()) m.ack_progress = EClock::now();
    ShardSent ent;
    ent.seq = seq;
    ent.slot = slot;
    ent.taken = taken;
    m.unacked.push_back(ent);
    // in-flight reference for the send below, taken under p->mu (the
    // TxPool r07 rationale: a racing ACK/detach may drop the ledger
    // reference the moment the lock releases)
    if (slot) slot->refs.fetch_add(1, std::memory_order_relaxed);
    if (taken) taken->refs.fetch_add(1, std::memory_order_relaxed);
  }
  int32_t r = st_node_send_zc(p->node, link, data, (int32_t)len, 0.05,
                              slot ? tx_slot_release : taken_release,
                              slot ? (void*)slot : (void*)taken);
  if (r != 1) {
    // bounced/dead: the transport took no ownership — drop the in-flight
    // reference; the entry stays ledgered and go-back-N re-sends it
    if (slot) p->txpool.unref(slot);
    if (taken) taken_unref(taken);
  }
  return true;
}

// Owner-side apply with end-to-end dedup: the (origin, fwd_seq) window
// check/insert and the slice apply commit together under p->mu — the
// same one-mutex discipline node.py's _apply_fwd/_dedup_mu carries, so a
// checkpoint capture under the same mutex can never persist a window seq
// whose mass missed the slice. Caller holds p->mu and has verified
// ownership. Returns true (the message is consumed either way).
bool shard_apply_fwd(ShardPlane* p, int32_t shard, uint8_t* data,
                     uint32_t len, std::vector<float>& sscratch,
                     std::vector<uint32_t>& wscratch) ST_REQUIRES(p->mu) {
  const ShardGeom& g = p->geom[(size_t)shard];
  uint32_t wlo, wcnt, origin, fseq;
  std::memcpy(&wlo, data + 5, 4);
  std::memcpy(&wcnt, data + 9, 4);
  std::memcpy(&origin, data + 13, 4);
  std::memcpy(&fseq, data + 17, 4);
  size_t per = (size_t)p->L * 4 + (size_t)g.wcnt * 4;
  int64_t body = (int64_t)len - (int64_t)kFwdHdr;
  int64_t nf = per > 0 ? body / (int64_t)per : 0;
  if ((int64_t)wlo != g.wlo || (int64_t)wcnt != g.wcnt || body <= 0 ||
      body % (int64_t)per != 0 || nf < 1 || nf > 255) {
    // relays forward verbatim without decoding, so a frame a fault
    // corrupted upstream is first DECODED here at the owner — drop it
    // loudly instead of poisoning the slice (node.py's decode guard)
    p->fwd_undecodable++;
    return true;
  }
  auto& win = p->dedup[origin];
  if (win.first.count(fseq)) {
    p->dedup_discards++;
    st_obs_emit(p->obs_id, kEvShardDedup, 0, (uint64_t)fseq);
    return true;
  }
  win.first.insert(fseq);
  win.second.push_back(fseq);
  while (win.second.size() > kShardDedupWindow) {
    win.first.erase(win.second.front());
    win.second.pop_front();
  }
  auto oit = p->owned.find(shard);
  float* vals = oit->second.data();
  // the 21-byte header leaves the frame body 1 (mod 4): gather every
  // frame's scales (global leaf rows -> synthetic slice rows) and words
  // into aligned scratch — the relay path, which never decodes, is what
  // stays zero-copy — sanitizing non-finite scales at the trust
  // boundary (wire.decode_fwd's twin), then apply the WHOLE burst in
  // one fused pass over the synthetic layout (stc_apply_frames, the
  // classic receive kernel).
  size_t nsyn = g.syn_g.size();
  if (sscratch.size() < (size_t)nf * nsyn)
    sscratch.resize((size_t)nf * nsyn);
  if (wscratch.size() < (size_t)(nf * g.wcnt))
    wscratch.resize((size_t)(nf * g.wcnt));
  uint64_t frames = 0;
  float sv;
  for (int64_t f = 0; f < nf; f++) {
    const uint8_t* fp = data + kFwdHdr + (size_t)f * per;
    bool anyf = false;
    for (size_t i = 0; i < nsyn; i++) {
      std::memcpy(&sv, fp + (size_t)g.syn_g[i] * 4, 4);
      if (!std::isfinite(sv)) sv = 0.0f;
      sscratch[(size_t)f * nsyn + i] = sv;
      if (sv != 0.0f) anyf = true;
    }
    if (anyf) frames++;
    std::memcpy(wscratch.data() + (size_t)f * g.wcnt,
                fp + (size_t)p->L * 4, (size_t)g.wcnt * 4);
  }
  if (frames > 0) {
    stc_apply_frames(vals, vals, g.syn_off.data(), g.syn_ns.data(),
                     g.syn_padded.data(), (int64_t)nsyn, g.wcnt,
                     (int32_t)nf, sscratch.data(), wscratch.data(), nullptr,
                     nullptr, nullptr);
    p->fwd_msgs_in++;
    p->fwd_frames_in += frames;
  }
  return true;
}

// Apply locally (owner), relay toward the owner, or return false (the
// caller parks). `slot`/`taken`/`data` carry the message exactly like
// shard_ledger_send; on a true return the passed reference is consumed.
// arrival = -1 for re-dispatch (link death / unpark) — which, per the
// r16 discipline, re-routes under the UNCHANGED end-to-end identity so a
// delivered-but-unacked copy dies in the owner's dedup window.
bool shard_dispatch(ShardPlane* p, int32_t shard, TxSlot* slot,
                    TakenBuf* taken, uint8_t* data, uint32_t len,
                    int32_t arrival, std::vector<float>& sscratch,
                    std::vector<uint32_t>& wscratch) ST_EXCLUDES(p->mu) {
  int32_t hop = -1;
  {
    StLockGuard lk(p->mu);
    if (p->owned.count(shard) && !p->ho_sent.count(shard)) {
      shard_apply_fwd(p, shard, data, len, sscratch, wscratch);
      if (slot) p->txpool.unref(slot);
      if (taken) taken_unref(taken);
      return true;
    }
    hop = shard_next_hop(p, shard, arrival);
  }
  if (hop < 0) return false;
  if (!shard_ledger_send(p, hop, slot, taken, data, len)) return false;
  if (arrival >= 0) p->relayed++;
  return true;
}

// Re-dispatch a parked/rolled-back FWD held as plain bytes: re-pack into
// a fresh tx slot (the original buffer is gone) and dispatch. False =
// still routeless (caller re-parks the bytes).
bool shard_dispatch_bytes(ShardPlane* p, int32_t shard,
                          const std::vector<uint8_t>& bytes,
                          std::vector<float>& sscratch,
                          std::vector<uint32_t>& wscratch)
    ST_EXCLUDES(p->mu) {
  {
    // owner fast path: no slot needed
    StLockGuard lk(p->mu);
    if (p->owned.count(shard) && !p->ho_sent.count(shard)) {
      shard_apply_fwd(p, shard, const_cast<uint8_t*>(bytes.data()),
                      (uint32_t)bytes.size(), sscratch, wscratch);
      return true;
    }
    if (shard_next_hop(p, shard, -1) < 0) return false;
  }
  TxSlot* slot = p->txpool.acquire();
  uint32_t off = (uint32_t)(kBodyOff - kFwdHdr);
  std::memcpy(slot->buf.data() + off, bytes.data(), bytes.size());
  slot->wire_off = off;
  slot->wire_len = (uint32_t)bytes.size();
  if (!shard_dispatch(p, shard, slot, nullptr, slot->buf.data() + off,
                      (uint32_t)bytes.size(), -1, sscratch, wscratch)) {
    p->txpool.unref(slot);
    return false;
  }
  return true;
}

// Go-back-N retransmission pass (the engine retransmit_pass twin, minus
// rollback: FWD ledger entries re-dispatch at detach instead of rolling
// back into a residual). Black-hole links tear down via st_node_drop_link
// — Python's LINK_DOWN handler detaches and re-routes the ledger.
void shard_retransmit(ShardPlane* p) ST_EXCLUDES(p->mu) {
  if (p->ack_timeout <= 0) return;
  auto now = EClock::now();
  std::vector<int32_t> ids;
  {
    StLockGuard lk(p->mu);
    for (auto& kv : p->members)
      if (!kv.second.dead) ids.push_back(kv.first);
  }
  for (int32_t id : ids) {
    std::vector<std::pair<const uint8_t*, uint32_t>> tail;
    std::vector<ShardSent> held;
    bool teardown = false;
    {
      StLockGuard lk(p->mu);
      auto it = p->members.find(id);
      if (it == p->members.end() || it->second.dead) continue;
      SMember& m = it->second;
      if (m.unacked.empty()) continue;
      double waited =
          std::chrono::duration<double>(now - m.ack_progress).count();
      int32_t shift = m.retx_rounds < 3 ? m.retx_rounds : 3;
      if (waited < p->ack_timeout * (double)(1 << shift)) continue;
      m.retx_rounds++;
      m.ack_progress = now;
      if (m.retx_rounds > p->ack_retry_limit) {
        m.dead = true;
        teardown = true;
      } else {
        size_t k = m.unacked.size() < kRetxPrefix ? m.unacked.size()
                                                  : kRetxPrefix;
        for (size_t i = 0; i < k; i++) {
          ShardSent& e = m.unacked[i];
          const uint8_t* d;
          uint32_t n;
          if (e.slot) {
            e.slot->refs.fetch_add(1, std::memory_order_relaxed);
            d = e.slot->buf.data() + e.slot->wire_off;
            n = e.slot->wire_len;
          } else {
            e.taken->refs.fetch_add(1, std::memory_order_relaxed);
            d = e.taken->data;
            n = e.taken->len;
          }
          tail.emplace_back(d, n);
          held.push_back(e);
        }
      }
    }
    if (teardown) {
      st_obs_emit(p->obs_id, kEvBlackhole, id, (uint64_t)p->ack_retry_limit);
      st_node_drop_link(p->node, id);
      continue;
    }
    if (!tail.empty()) {
      p->retx_msgs += (uint64_t)tail.size();
      st_obs_emit(p->obs_id, kEvRetransmit, id, (uint64_t)tail.size());
    }
    for (size_t i = 0; i < tail.size(); i++) {
      ShardSent& e = held[i];
      int32_t r = st_node_send_zc(
          p->node, id, tail[i].first, (int32_t)tail[i].second, 0.1,
          e.slot ? tx_slot_release : taken_release,
          e.slot ? (void*)e.slot : (void*)e.taken);
      if (r != 1) {
        for (size_t j = i; j < held.size(); j++)
          shard_entry_unref(p, held[j]);
        break;
      }
    }
  }
}

void shard_flush_acks(ShardPlane* p, int32_t id, SMember& m)
    ST_REQUIRES(p->mu) {
  // cumulative + retried + RE-ANNOUNCED on duplicates (node.py: a dup
  // usually means our ACK was lost — a sender whose retransmissions are
  // silently discarded without a fresh ACK is wedged forever)
  if (!m.ack_due || m.dead) return;
  uint8_t ack[9];
  ack[0] = kAck;
  uint64_t c = m.rx_count;
  std::memcpy(ack + 1, &c, 8);
  int32_t r = st_node_send(p->node, id, ack, 9, 0.0);
  if (r == 1 || r < 0) {
    m.ack_due = false;
    m.ack_sent = m.rx_count;
  }
}

void shard_unpark(ShardPlane* p, std::vector<float>& sscratch,
                  std::vector<uint32_t>& wscratch) ST_EXCLUDES(p->mu) {
  std::deque<ParkedFwd> work;
  {
    StLockGuard lk(p->mu);
    if (p->parked.empty()) return;
    work.swap(p->parked);
  }
  for (auto& pf : work) {
    if (!shard_dispatch_bytes(p, pf.shard, pf.bytes, sscratch, wscratch)) {
      StLockGuard lk(p->mu);
      shard_park(p, pf.shard, pf.bytes.data(), (uint32_t)pf.bytes.size());
    }
  }
}

// ---- shard sender: the outbox pump ----------------------------------------

void shard_sender_loop(ShardPlane* p) {
  std::vector<float> sscratch;
  std::vector<uint32_t> wscratch;
  ShardScratch scr;
  while (!p->stop.load()) {
    uint64_t seq_before;
    {
      StLockGuard lk(p->wmu);
      seq_before = p->wseq;
    }
    bool sent_any = false;
    bool blocked = false;  // work exists but the queue/window gated it
    std::vector<int32_t> shards;
    {
      StLockGuard lk(p->mu);
      for (auto& kv : p->outbox)
        if (!p->owned.count(kv.first)) shards.push_back(kv.first);
    }
    for (int32_t shard : shards) {
      if (p->stop.load()) return;
      int32_t hop;
      {
        StLockGuard lk(p->mu);
        hop = shard_next_hop(p, shard, -1);
      }
      if (hop < 0) continue;  // mass stays until a route heals
      // control-traffic headroom (node.py _queue_room): the pump must
      // never race the ACKs/shard control for the last sendq slots
      if (st_node_sendq_room(p->node, hop) < kCtrlHeadroom) {
        blocked = true;
        continue;
      }
      for (int msg = 0; msg < kOutboxMsgsPerPass; msg++) {
        const ShardGeom& g = p->geom[(size_t)shard];
        size_t per = (size_t)p->L * 4 + (size_t)g.wcnt * 4;
        {
          // window pre-check BEFORE paying for a quantize (node.py
          // _pump_outboxes): a full ledger leaves the mass in the
          // residual, where error feedback keeps it exact
          StLockGuard lk(p->mu);
          auto mit = p->members.find(hop);
          if (mit == p->members.end() || mit->second.dead ||
              mit->second.unacked.size() >= kSendWindow)
            break;
        }
        TxSlot* slot = p->txpool.acquire();
        uint8_t* body = slot->buf.data() + kBodyOff;
        int32_t nf = 0;
        uint32_t fseq = 0;
        {
          StLockGuard lk(p->mu);
          auto it = p->outbox.find(shard);
          if (it == p->outbox.end() || p->owned.count(shard)) {
            p->txpool.unref(slot);
            break;
          }
          // ONE measurement per message, the cascade-halving schedule,
          // every word plane in one AVX-512 memory pass — the classic
          // plane's machinery (slice_cascade_message; the per-frame
          // scalar path measured ~60 msgs/s where this shape does
          // thousands)
          nf = slice_cascade_message(p, g, it->second.data(), g.kcap,
                                     body, per, scr);
          if (nf == 0) {
            // drained to dust: FREE the outbox (the transient-memory
            // contract — state.drain_outbox_frames' twin)
            p->outbox.erase(it);
            p->txpool.unref(slot);
            break;
          }
          fseq = ++p->fwd_seq;
        }
        uint32_t off = (uint32_t)(kBodyOff - kFwdHdr);
        uint8_t* H = slot->buf.data() + off;
        H[0] = kFwd;
        uint32_t z = 0, wlo32 = (uint32_t)g.wlo, wc32 = (uint32_t)g.wcnt;
        std::memcpy(H + 1, &z, 4);  // per-link seq stamped by ledger_send
        std::memcpy(H + 5, &wlo32, 4);
        std::memcpy(H + 9, &wc32, 4);
        std::memcpy(H + 13, &p->origin, 4);
        std::memcpy(H + 17, &fseq, 4);
        slot->wire_off = off;
        slot->wire_len = (uint32_t)(kFwdHdr + (size_t)nf * per);
        if (!shard_dispatch(p, shard, slot, nullptr, H, slot->wire_len, -1,
                            sscratch, wscratch)) {
          // window filled / hop died mid-pump: park the encoded frames
          // under their identity (the residual was already debited —
          // error feedback lives in the frames now)
          StLockGuard lk(p->mu);
          shard_park(p, shard, H, slot->wire_len);
          p->txpool.unref(slot);
          break;
        }
        p->fwd_msgs_out++;
        p->fwd_frames_out += (uint64_t)nf;
        sent_any = true;
      }
    }
    shard_unpark(p, sscratch, wscratch);
    shard_retransmit(p);
    if (!sent_any && !p->stop.load()) {
      // blocked = mass waiting on sendq/window drain: come back on the
      // transport's timescale (a 20 ms nap here paced the whole plane
      // at ~250 msgs/s — the first bench run's wall); idle = wait for a
      // wake (add / ACK / route) with the retransmit-timer backstop
      StUniqueLock lk(p->wmu);
      auto nap_deadline = st_cv_deadline(blocked ? 0.0005 : 0.02);
      while (p->wseq <= seq_before && !p->stop.load()) {
        if (p->wcv.wait_until(lk.native(), nap_deadline) ==
            std::cv_status::timeout)
          break;
      }
    }
  }
}

// ---- shard receiver -------------------------------------------------------

void shard_recv_loop(ShardPlane* p) {
  std::vector<float> sscratch;
  std::vector<uint32_t> wscratch;
  while (!p->stop.load()) {
    uint64_t seq0 = st_node_data_seq(p->node);
    bool busy = false;
    std::vector<int32_t> ids;
    {
      StLockGuard lk(p->mu);
      for (auto& kv : p->members)
        if (!kv.second.dead) ids.push_back(kv.first);
    }
    for (int32_t id : ids) {
      for (int iter = 0; iter < 256; iter++) {
        const uint8_t* buf = nullptr;
        void* tok = nullptr;
        int32_t n = st_node_recv_take(p->node, id, &buf, &tok);
        if (n == 0) break;
        if (n < 0) {
          StLockGuard lk(p->mu);
          auto it = p->members.find(id);
          if (it != p->members.end()) it->second.dead = true;
          break;
        }
        busy = true;
        uint8_t kind = buf[0];
        if (kind == kFwd && (size_t)n >= kFwdHdr) {
          uint32_t seq;
          std::memcpy(&seq, buf + 1, 4);
          int32_t shard = -1;
          bool accept = false;
          {
            StLockGuard lk(p->mu);
            auto it = p->members.find(id);
            if (it != p->members.end()) {
              SMember& m = it->second;
              if (seq != (uint32_t)(m.rx_count + 1)) {
                // dup or gap: discard unapplied, RE-ANNOUNCE the ACK
                // (node.py: the dup usually means our ACK was lost)
                m.ack_due = true;
              } else {
                m.rx_count++;
                m.ack_due = true;
                uint32_t wlo;
                std::memcpy(&wlo, buf + 5, 4);
                shard = shard_of_word(p, wlo);
                accept = shard >= 0;
                if (shard < 0) p->fwd_undecodable++;
              }
            }
          }
          if (accept) {
            auto* tb = new TakenBuf();
            tb->plane = p;
            tb->tok = tok;
            tb->data = const_cast<uint8_t*>(buf);
            tb->len = (uint32_t)n;
            tb->from_link = id;
            tb->refs.store(1, std::memory_order_relaxed);
            p->taken_live.fetch_add(1, std::memory_order_acq_rel);
            if (!shard_dispatch(p, shard, nullptr, tb, tb->data, tb->len,
                                id, sscratch, wscratch)) {
              StLockGuard lk(p->mu);
              shard_park(p, shard, tb->data, tb->len);
              taken_unref(tb);
            }
          } else {
            st_node_take_free(p->node, id, tok);
          }
        } else if (kind == kAck && n == 9) {
          uint64_t count;
          std::memcpy(&count, buf + 1, 8);
          st_node_take_free(p->node, id, tok);
          bool opened = false;
          {
            StLockGuard lk(p->mu);
            auto it = p->members.find(id);
            if (it != p->members.end()) {
              SMember& m = it->second;
              bool progressed = false;
              while (!m.unacked.empty() && m.unacked.front().seq <= count) {
                shard_entry_unref(p, m.unacked.front());
                m.unacked.pop_front();
                progressed = true;
              }
              if (progressed) {
                m.ack_progress = EClock::now();
                m.retx_rounds = 0;
                opened = true;
              }
            }
          }
          if (opened) p->wake();  // window opened: outboxes/park may drain
        } else {
          // control plane (SHARD JSON, DIGEST, handshake strays): hand to
          // Python in arrival order
          {
            StLockGuard lk(p->cmu);
            p->ctrl.emplace_back(id, std::vector<uint8_t>(buf, buf + n));
          }
          st_node_take_free(p->node, id, tok);
        }
      }
      {
        StLockGuard lk(p->mu);
        auto it = p->members.find(id);
        if (it != p->members.end()) shard_flush_acks(p, id, it->second);
      }
    }
    if (!busy && !p->stop.load()) {
      st_node_wait_data(p->node, seq0, 0.05);
    }
  }
}

}  // namespace

// ---- C ABI ---------------------------------------------------------------

extern "C" {

__attribute__((visibility("default"))) void* st_engine_create(
    void* node, const int64_t* off, const int64_t* ns, const int64_t* padded,
    int64_t n_leaves, int64_t total, int64_t total_n,
    const float* init_values /* or NULL */, int32_t policy, int32_t per_leaf,
    int32_t burst, int32_t recv_cap, int32_t compat_frame_bytes,
    int32_t quarantine_send_failures, double ack_timeout_sec,
    int32_t ack_retry_limit, int32_t trace_wire) {
  if (compat_frame_bytes > 0 &&
      (n_leaves != 1 || compat_frame_bytes < 5 ||
       (int64_t)(compat_frame_bytes - 4) > total / 8))
    return nullptr;  // compat: one flat tensor, mask must fit the words
  auto* e = new Engine();
  e->node = node;
  e->obs_id = st_node_obs_id(node);  // tag engine events with the node
  e->L = n_leaves;
  e->total = total;
  e->total_n = total_n;
  e->W = total / 32;
  e->off.assign(off, off + n_leaves);
  e->ns.assign(ns, ns + n_leaves);
  e->padded.assign(padded, padded + n_leaves);
  e->policy = policy;
  e->per_leaf = per_leaf != 0;
  e->burst = burst < 1 ? 1 : (burst > 255 ? 255 : burst);
  // Compat bursts ARE protocol-legal: the reference stream is just
  // back-to-back fixed-size frames, so K quantized frames concatenated in
  // one wire message are indistinguishable from K sequential sends to any
  // reference peer — while costing ONE lock cycle + ONE write here.
  e->compat_bytes = compat_frame_bytes > 0 ? compat_frame_bytes : 0;
  e->recv_cap = recv_cap;
  e->quarantine = quarantine_send_failures > 0 ? quarantine_send_failures : 0;
  e->ack_timeout = ack_timeout_sec > 0 ? ack_timeout_sec : 0.0;
  // <= 0 coerces to 1 round, matching peer.py _check_retransmit's
  // max(1, ack_retry_limit) — the knob must mean the same thing on
  // both data planes
  e->ack_retry_limit = ack_retry_limit > 0 ? ack_retry_limit : 1;
  // trace context is native-framing only (the reference compat protocol
  // has no header to extend)
  e->trace_wire = (trace_wire != 0 && compat_frame_bytes <= 0) ? 1 : 0;
  {
    // values is ST_GUARDED_BY(mu); the engine is not shared yet, but
    // take the lock anyway — uncontended, and -Wthread-safety cannot
    // see "not published yet"
    StLockGuard lk(e->mu);
    e->values.assign((size_t)total, 0.0f);
    if (init_values)
      std::memcpy(e->values.data(), init_values, (size_t)total * 4);
  }
  // tx ring slot size: kBodyOff bytes of header room (body 8-aligned for
  // the codec kernels; headers pack flush against it) + the largest
  // message this engine can emit. The window (kSendWindow) bounds live
  // slots per link; keep_warm bounds idle memory.
  e->txpool.slot_bytes =
      kBodyOff + (size_t)e->burst * ((size_t)e->L * 4 + (size_t)e->W * 4);
  return e;
}

// r11 codec configuration — call between st_engine_create and
// st_engine_start (the sender thread reads these unlocked; the tx-slot
// ring is re-sized here for the widest message the mode can emit).
// prec_mode: 0 = fixed 1-bit, 1 = telemetry-adaptive precision (the
// governor upshifts capable links to sign2 when their residual RMS stops
// decaying and downshifts quiet ones), 2 = fixed sign2 on capable links
// (the A/B arm). cascade: frames quantized per memory pass (1 = the r10
// per-frame re-measured schedule; >1 = halving cascade, stcodec.c r11).
__attribute__((visibility("default"))) void st_engine_set_codec(
    void* h, int32_t prec_mode, double up_ratio, double down_ratio,
    double interval_sec, int32_t cascade) {
  if (!h) return;
  auto* e = (Engine*)h;
  e->prec_mode = prec_mode == 1 || prec_mode == 2 ? prec_mode : 0;
  if (up_ratio > 0) e->gov_up_ratio = up_ratio;
  if (down_ratio > 0) e->gov_down_ratio = down_ratio;
  if (interval_sec > 0) e->gov_interval = interval_sec;
  e->cascade = cascade < 1 ? 1 : (cascade > 64 ? 64 : cascade);
  if (e->prec_mode != 0 && !e->compat_bytes) {
    // slots must fit the widest message either precision can emit: the
    // sign2 burst is capped to the receive bound, which can exceed the
    // 1-bit burst's bytes when the 1-bit cap was frame-count-limited
    size_t per2 = frame_bytes(e) + (size_t)e->W * 4;
    int64_t cap2 = ((int64_t)e->recv_cap - (int64_t)kHdrV3) /
                   (int64_t)per2;
    if (cap2 < 1) cap2 = 1;
    if (cap2 > e->burst) cap2 = e->burst;
    size_t need = kBodyOff + (size_t)cap2 * per2;
    if (need > e->txpool.slot_bytes) e->txpool.slot_bytes = need;
  }
}

// r11: the peer on link_id advertised sign2 decode capability
// (compat.SYNC_FLAG_SIGN2 / the WELCOME flags byte) — emission to it may
// upshift. Without this call a link stays 1-bit forever (mixed-tree
// safety default).
__attribute__((visibility("default"))) int32_t st_engine_link_allow_sign2(
    void* h, int32_t link_id, int32_t allow) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) return 0;
  it->second.peer_sign2 = allow != 0;
  return 1;
}

// r14: the peer on link_id advertised the r14 capability (the SYNC/
// WELCOME shm flag — compat.SYNC_FLAG_SHM doubles as the r14 marker) —
// emission to it may use the aligned v3 framing, whose 24-byte header
// lets the receiver apply frames straight from the wire body. Without
// this call a link stays on v2 forever (mixed-tree safety default).
__attribute__((visibility("default"))) int32_t st_engine_link_wire_v3(
    void* h, int32_t link_id, int32_t allow) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) return 0;
  it->second.wire_v3 = allow != 0;
  return 1;
}

// r11: the governor's current precision choice for the link (1 or 2; 0 =
// unknown link / closed engine) — the st_link_precision gauge.
__attribute__((visibility("default"))) int32_t st_engine_link_precision(
    void* h, int32_t link_id) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) return 0;
  if (e->prec_mode == 2) return it->second.peer_sign2 ? 2 : 1;
  return it->second.prec;
}

__attribute__((visibility("default"))) void st_engine_start(void* h) {
  // Every entry point NULL-checks its handle: a late ctypes call after
  // st_engine_destroy must no-op/return-empty, never dereference NULL —
  // st_engine_counters(NULL) was a process-killing SIGSEGV under pytest's
  // failure repr (VERDICT r05 Weak #2). The Python facade guards too;
  // this is the defense-in-depth layer.
  if (!h) return;
  auto* e = (Engine*)h;
  e->send_thread = std::thread(sender_loop, e);
  e->recv_thread = std::thread(receiver_loop, e);
}

// Seal ingress for a graceful leave (see Engine::sealed).
__attribute__((visibility("default"))) void st_engine_seal(void* h) {
  if (!h) return;
  auto* e = (Engine*)h;
  e->sealed.store(true);
  st_obs_emit(e->obs_id, kEvSeal, -1, 0);
}

// Stop the engine threads. MUST be called before st_node_close (the threads
// block inside the node's condvars/queues).
__attribute__((visibility("default"))) void st_engine_stop(void* h) {
  if (!h) return;
  auto* e = (Engine*)h;
  e->stop.store(true);
  e->wake();
  if (e->send_thread.joinable()) e->send_thread.join();
  if (e->recv_thread.joinable()) e->recv_thread.join();
}

__attribute__((visibility("default"))) void st_engine_destroy(void* h) {
  auto* e = (Engine*)h;
  if (!e) return;
  // Drop the ledger references still held by attached links' unacked
  // entries (no rollback — the engine is dying, there is no residual left
  // to repair; Python detached/stashed everything it wanted first).
  {
    StLockGuard lk(e->mu);
    for (auto& kv : e->links) {
      drop_msgs(e, kv.second.unacked);
      drop_msgs(e, kv.second.rolled);
    }
    drop_msgs(e, e->kept);
  }
  // Transport release callbacks can still be in flight for a moment after
  // st_node_close returns: a link's queues are destroyed on its detached
  // I/O threads' exit path, AFTER the node's thread accounting is
  // decremented — so a queued zero-copy message's release(ctx) may fire
  // microseconds from now. Freeing the pool those callbacks point into
  // would be a use-after-free; wait for every slot reference to drain
  // (normally instantaneous), and prefer leaking to freeing under a live
  // thread if a wedged peer keeps one pinned.
  for (int i = 0;; i++) {
    bool busy = false;
    {
      StLockGuard lk(e->txpool.mu);
      for (auto& s : e->txpool.all_)
        if (s->refs.load(std::memory_order_acquire) != 0) {
          busy = true;
          break;
        }
    }
    if (!busy) break;
    if (i >= 2000) return;  // ~2 s: leak rather than free under a live thread
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  delete e;
}

// values += sanitize(u), every residual += sanitize(u)
// (core.SharedTensor.add / reference addFromInternal src/sharedtensor.c:
// 334-344, with quirks Q7/Q9 fixed).
__attribute__((visibility("default"))) void st_engine_add(void* h,
                                                          const float* u) {
  if (!h) return;
  auto* e = (Engine*)h;
  {
    // r11 staged add: accumulate sanitize+clip(u) into the pending buffer
    // under add_mu ONLY — the trainer never waits on the data-plane
    // mutex (a multi-pass message quantize used to hold it ~ms). The
    // fold into values/residuals/carry — including the dead links whose
    // residual is the re-graft carry, and the fused partials refresh —
    // happens in fold_pending at the next data-plane safe point.
    StLockGuard alk(e->add_mu);
    if (e->upend.empty()) {
      // ufold (the fold scratch) is sized lazily by fold_pending — it is
      // mu-guarded and this path holds only add_mu
      e->upend.assign((size_t)e->total, 0.0f);
    }
    stc_accumulate_update_to(e->upend.data(), e->upend.data(), u,
                             e->off.data(), e->ns.data(), e->padded.data(),
                             e->L);
    if (e->trace_wire)
      e->pend_gen.store(st_obs_now_ns(), std::memory_order_relaxed);
    e->has_pending.store(true, std::memory_order_release);
  }
  e->updates++;
  e->wake();
}

__attribute__((visibility("default"))) void st_engine_read(void* h,
                                                           float* out) {
  if (!h) return;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  fold_pending(e);
  std::memcpy(out, e->values.data(), (size_t)e->total * 4);
}

// Open a link with residual = values - peer_snapshot (the diff handshake
// seed, core.SharedTensor.new_link_diff). snapshot NULL => zero residual;
// seed!=0 => residual = full replica (reference join seeding). rx_init
// carries the cumulative receive count Python accumulated before attach so
// the ACK stream stays monotonic.
__attribute__((visibility("default"))) int32_t st_engine_attach(
    void* h, int32_t link_id, const float* snapshot, int32_t seed,
    uint64_t rx_init) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  {
    StLockGuard lk(e->mu);
    fold_pending(e);  // the diff seed must include staged adds
    if (e->links.count(link_id)) return 0;  // already exists
    ELink& lk2 = e->links[link_id];
    lk2.resid.assign((size_t)e->total, 0.0f);
    if (snapshot) {
      for (int64_t i = 0; i < e->total; i++)
        lk2.resid[i] = e->values[i] - snapshot[i];
    } else if (seed) {
      std::memcpy(lk2.resid.data(), e->values.data(), (size_t)e->total * 4);
    }
    lk2.rx_count = rx_init;
    lk2.ack_sent = rx_init;
    lk2.dirty = true;
  }
  e->wake();
  return 1;
}

// r10: open a SUBSCRIBER link — read-only leaf, unledgered (no unacked
// entries, no ACK expectation, no go-back-N: a lost message is a seq gap
// the subscriber repairs with a resync handshake), optionally filtered to
// a word range (kRData framing ships only words [word_lo, word_lo+word_cnt)
// per frame; word_cnt <= 0 subscribes the whole table), with kFresh drain
// marks every fresh_interval_sec while idle. Residual seeds like
// st_engine_attach (values - snapshot; NULL snapshot = full replica), then
// zeroes outside the range — mass nobody will ever receive must not keep
// the sender busy. Attach and mode-set are ONE atomic step ON PURPOSE: a
// two-call attach-then-mark would let this sender emit a LEDGERED message
// in the window, whose missing ACK would black-hole the link.
// Returns 0 on duplicate link or compat mode (no SYNC handshake there, so
// no subscribers).
__attribute__((visibility("default"))) int32_t st_engine_attach_sub(
    void* h, int32_t link_id, const float* snapshot, uint64_t rx_init,
    int64_t word_lo, int64_t word_cnt, double fresh_interval_sec) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  if (e->compat_bytes) return 0;
  {
    StLockGuard lk(e->mu);
    fold_pending(e);  // the sub seed must include staged adds
    if (e->links.count(link_id)) return 0;
    ELink& lk2 = e->links[link_id];
    lk2.resid.assign((size_t)e->total, 0.0f);
    if (snapshot) {
      for (int64_t i = 0; i < e->total; i++)
        lk2.resid[i] = e->values[i] - snapshot[i];
    } else {
      std::memcpy(lk2.resid.data(), e->values.data(), (size_t)e->total * 4);
    }
    if (word_cnt <= 0 || word_lo < 0 || word_lo + word_cnt > e->W) {
      word_lo = 0;
      word_cnt = e->W;
    }
    lk2.subscriber = true;
    lk2.wlo = word_lo;
    lk2.wcnt = word_cnt;
    lk2.ranged = (word_lo > 0 || word_cnt < e->W);
    if (lk2.ranged) {
      std::fill(lk2.resid.begin(), lk2.resid.begin() + word_lo * 32, 0.0f);
      std::fill(lk2.resid.begin() + (word_lo + word_cnt) * 32,
                lk2.resid.end(), 0.0f);
    }
    lk2.fresh_interval_ns =
        fresh_interval_sec > 0 ? (uint64_t)(fresh_interval_sec * 1e9) : 0;
    lk2.rx_count = rx_init;
    lk2.ack_sent = rx_init;
    lk2.dirty = true;
  }
  st_obs_emit(e->obs_id, kEvSubAttach, link_id, (uint64_t)word_cnt);
  e->wake();
  return 1;
}

// The wire-compat LEAF re-graft as ONE atomic step (the C analog of
// core.SharedTensor.regraft_reset_to_carry, same rationale): consume the
// carry, set the replica to EXACTLY the carry (fresh-joiner semantics — a
// true fresh joiner with pending adds holds them in values AND residual;
// the parent's full-replica re-seed then refills tree state additively),
// and open the new uplink with the carry as its residual. Resetting to
// zero instead would desync this node by the carry forever (split horizon
// never returns it). Returns 0 if the link already exists.
__attribute__((visibility("default"))) int32_t st_engine_compat_regraft(
    void* h, int32_t link_id) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  {
    StLockGuard lk(e->mu);
    fold_pending(e);
    if (e->links.count(link_id)) return 0;
    ELink& l = e->links[link_id];
    if (e->has_carry) {
      l.resid = e->carry;             // copy: the residual the tree is owed
      e->values = std::move(e->carry);  // replica = exactly the carry
      e->has_carry = false;
      e->carry.clear();
      e->carry.shrink_to_fit();
    } else {
      std::fill(e->values.begin(), e->values.end(), 0.0f);
      l.resid.assign((size_t)e->total, 0.0f);
    }
    l.dirty = true;
  }
  e->wake();
  return 1;
}

// Park a dead uplink's residual (unacked rolled back) into the LIVE carry
// slot, which keeps accumulating add()/flood mass until the re-graft
// consumes it (see Engine::carry). The rolled-back messages become the
// severed link's record (Engine::kept), in place of any earlier one;
// out1[0] is their frames with a nonzero scale. Returns 1 if the link
// existed (out1 untouched otherwise).
__attribute__((visibility("default"))) int32_t st_engine_stash_carry(
    void* h, int32_t link_id, uint64_t* out1) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  fold_pending(e);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) return 0;
  drop_msgs(e, e->kept);
  e->kept = std::move(it->second.rolled);
  rollback_unacked(e, it->second, &e->kept);
  uint64_t rolled = 0;
  for (const auto& msg : e->kept)
    for (int32_t f = 0; f < msg.nframes; f++) {
      const float* fs;
      const uint32_t* fw;
      msg_frame(e, msg, f, &fs, &fw);
      rolled += any_nonzero(fs, e->L);
    }
  out1[0] = rolled;
  if (!e->has_carry) {
    e->carry = std::move(it->second.resid);
    e->has_carry = true;
  } else {
    for (int64_t i = 0; i < e->total; i++)
      e->carry[i] += it->second.resid[i];
  }
  e->links.erase(it);
  return 1;
}

// Atomically read the replica snapshot AND consume the carry (one lock —
// an add() between the two reads would land in the snapshot but not the
// carry, re-creating the orphan-add loss this slot exists to fix).
// Either out pointer may be NULL to skip that copy: the BECAME_MASTER
// failover only needs the consume side effect (the carry's mass is already
// in the now-authoritative replica) and must not pay two full-table copies
// for it. Returns 1 when the carry existed (and, if carry_out is non-NULL,
// was written), 0 otherwise.
__attribute__((visibility("default"))) int32_t st_engine_take_carry_and_snapshot(
    void* h, float* carry_out, float* values_out) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  fold_pending(e);
  if (values_out)
    std::memcpy(values_out, e->values.data(), (size_t)e->total * 4);
  if (!e->has_carry) return 0;
  if (carry_out)
    std::memcpy(carry_out, e->carry.data(), (size_t)e->total * 4);
  e->has_carry = false;
  e->carry.clear();
  e->carry.shrink_to_fit();
  return 1;
}

// Close a link; writes its undelivered residual (unacked frames rolled
// back) into out_resid (nullable), and into out1[0] the data messages
// applied from it, read under the lock that erases it: no message of the
// link is applied after the count (a severed child's re-join reports it).
// Returns 1 if the link existed (out1 untouched otherwise).
__attribute__((visibility("default"))) int32_t st_engine_detach(
    void* h, int32_t link_id, float* out_resid, uint64_t* out1) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  fold_pending(e);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) return 0;
  rollback_unacked(e, it->second);
  drop_msgs(e, it->second.rolled);
  if (out_resid)
    std::memcpy(out_resid, it->second.resid.data(), (size_t)e->total * 4);
  out1[0] = it->second.rx_count;
  e->links.erase(it);
  return 1;
}

// The re-join's WELCOME reported that the parent applied the severed
// link's messages up to wire seq `applied`: take those of the record
// (Engine::kept) back out of the replica, every link's residual and the
// carry — their frames with negated scales, each at its own precision —
// as core.SharedTensor.retract_frames does on the Python tiers, counted
// nowhere; then drop the record (0 drops it whole). Returns the frames
// retracted with a nonzero scale.
__attribute__((visibility("default"))) int64_t st_engine_retract_kept(
    void* h, uint64_t applied) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  int64_t retracted = 0;
  {
    StLockGuard lk(e->mu);
    fold_pending(e);
    std::vector<float> neg((size_t)e->L);
    std::vector<float*> targets{e->values.data()};
    for (auto& kv : e->links) targets.push_back(kv.second.resid.data());
    if (e->has_carry) targets.push_back(e->carry.data());
    for (const auto& msg : e->kept) {
      if (msg.seq > applied) continue;
      for (int32_t f = 0; f < msg.nframes; f++) {
        const float* fs;
        const uint32_t* fw;
        msg_frame(e, msg, f, &fs, &fw);
        if (!any_nonzero(fs, e->L)) continue;
        for (int64_t i = 0; i < e->L; i++) neg[i] = -fs[i];
        for (float* t : targets) {
          if (msg.prec == 2)
            stc_apply_frame2(t, t, e->off.data(), e->ns.data(),
                             e->padded.data(), e->L, e->W, neg.data(), fw);
          else
            stc_apply_frame(t, t, e->off.data(), e->ns.data(),
                            e->padded.data(), e->L, neg.data(), fw);
        }
        retracted++;
      }
    }
    if (retracted > 0)
      for (auto& kv : e->links) {
        kv.second.pvalid = false;  // bypasses the fused-partials kernels
        kv.second.dirty = true;
      }
    drop_msgs(e, e->kept);
  }
  if (retracted > 0) e->wake();
  return retracted;
}

// Apply k externally-decoded frames from src_link (which need not be
// attached — the pre-WELCOME flood-in case) to values + all other
// residuals. RX/ACK accounting for these stays with the caller.
__attribute__((visibility("default"))) void st_engine_inject(
    void* h, int32_t src_link, int32_t k, const float* scales,
    const uint32_t* words) {
  if (!h) return;
  auto* e = (Engine*)h;
  {
    StLockGuard lk(e->mu);
    // externally-decoded frames are python-tier 1-bit (the serve/handshake
    // paths never carry sign2)
    apply_batch(e, src_link, k, scales, words, 1);
  }
  e->wake();
}

__attribute__((visibility("default"))) int32_t st_engine_links(void* h,
                                                               int32_t* out,
                                                               int32_t cap) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  int32_t n = 0;
  for (auto& kv : e->links) {
    if (n >= cap) break;
    out[n++] = kv.first;
  }
  return n;
}

__attribute__((visibility("default"))) double st_engine_residual_rms(
    void* h, int32_t link_id) {
  if (!h) return 0.0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  fold_pending(e);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) {
    // the carry pseudo-slot (peer.CARRY_LINK == -1): an orphaned node's
    // owed mass lives here, not in any link — st_residual_norm must see
    // it or an orphan reads "quiesced" while still holding undelivered
    // updates. O(total) scan, but only reachable while a carry exists.
    if (link_id != -1 || !e->has_carry) return 0.0;
    double css = 0;
    const float* c = e->carry.data();
    for (int64_t i = 0; i < e->total; i++) css += (double)c[i] * (double)c[i];
    return std::sqrt(css / (double)e->total_n);
  }
  ELink& lk2 = it->second;
  // Fast path off the scale-partials cache: pss[] holds each leaf's
  // residual sum-of-squares, refreshed by every fused add/apply/quantize
  // pass — the exact quantity this scan would recompute. Matters because
  // the r09 digest beat (and drain()'s poll) samples this under e->mu
  // every interval on EVERY peer: a full O(total) walk here (64 MiB at
  // 16 Mi) would stall the data-plane threads that share the mutex. The
  // slow scan remains only for the rare cache-bypassing writes
  // (rollback, restore — pvalid false).
  double ss = 0;
  if (lk2.pvalid && (int64_t)lk2.pss.size() == e->L) {
    for (int64_t i = 0; i < e->L; i++) ss += lk2.pss[i];
  } else {
    const float* r = lk2.resid.data();
    for (int64_t i = 0; i < e->total; i++) ss += (double)r[i] * (double)r[i];
  }
  return std::sqrt(ss / (double)e->total_n);
}

__attribute__((visibility("default"))) int64_t st_engine_inflight(void* h) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  int64_t n = 0;
  for (auto& kv : e->links) n += (int64_t)kv.second.unacked.size();
  return n;
}

// counters: [frames_out, frames_in, updates, msgs_out, msgs_in,
//            tx_slot_acquires, tx_slot_alloc_events, tx_slots_allocated,
//            retx_msgs, dedup_discards, rtt_ns_total, rtt_msgs,
//            hops_sum, hops_msgs, staleness_ns_last, traced_msgs_in,
//            sub_msgs_out, sub_fresh_out,
//            prec_upshifts, prec_downshifts, frames2_out, frames2_in]
// [5..7] are the r07 tx-ring pool stats (steady state: acquires grow,
// alloc_events flat); [8..11] are the r08 obs aggregates (go-back-N
// retransmitted messages, dup/gap discards, and the ACK round-trip
// sum-of-ns + sample count); [12..15] the r09 trace aggregates (hop-count
// sum + sample count over applied traced messages, the most recent
// apply-time staleness in ns, and the traced-message count); [16..17] the
// r10 serving aggregates (unledgered subscriber data messages sent +
// kFresh drain marks delivered; [18..21] the r11 adaptive-precision
// aggregates — obs/schema.py names all of them canonically).
__attribute__((visibility("default"))) void st_engine_counters(
    void* h, uint64_t* out22) {
  if (!h) {  // the SIGSEGV that aborted the whole suite (r05 Weak #2)
    for (int i = 0; i < 22; i++) out22[i] = 0;
    return;
  }
  auto* e = (Engine*)h;
  out22[0] = e->frames_out.load();
  out22[1] = e->frames_in.load();
  out22[2] = e->updates.load();
  out22[3] = e->msgs_out.load();
  out22[4] = e->msgs_in.load();
  out22[5] = e->txpool.acquires.load();
  out22[6] = e->txpool.alloc_events.load();
  {
    StLockGuard lk(e->txpool.mu);
    out22[7] = (uint64_t)e->txpool.all_.size();
  }
  out22[8] = e->retx_msgs.load();
  out22[9] = e->dedup_discards.load();
  out22[10] = e->rtt_ns_total.load();
  out22[11] = e->rtt_msgs.load();
  out22[12] = e->hops_sum.load();
  out22[13] = e->hops_msgs.load();
  out22[14] = e->staleness_ns_last.load();
  out22[15] = e->traced_msgs_in.load();
  out22[16] = e->sub_msgs_out.load();
  out22[17] = e->sub_fresh_out.load();
  out22[18] = e->prec_upshifts.load();
  out22[19] = e->prec_downshifts.load();
  out22[20] = e->frames2_out.load();
  out22[21] = e->frames2_in.load();
}

// r09 per-link convergence telemetry: out2[0] = origin-stamp age (ns) of
// the latest traced message applied from this link, out2[1] = its hop
// distance from the origin. Returns 1 when the link exists. The peer's
// registry collector renders these as the st_staleness_seconds{link=} and
// st_update_hops-adjacent gauges (obs/schema.py).
__attribute__((visibility("default"))) int32_t st_engine_link_obs(
    void* h, int32_t link_id, uint64_t* out2) {
  out2[0] = out2[1] = 0;
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  auto it = e->links.find(link_id);
  if (it == e->links.end()) return 0;
  out2[0] = it->second.stale_ns;
  out2[1] = it->second.last_hops;
  return 1;
}

// Pop one control-plane message; returns its length (0 = none). link_out
// receives the source link id.
__attribute__((visibility("default"))) int32_t st_engine_poll_ctrl(
    void* h, int32_t* link_out, uint8_t* buf, int32_t cap) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->cmu);
  if (e->ctrl.empty()) return 0;
  auto& front = e->ctrl.front();
  *link_out = front.first;
  int32_t n = (int32_t)std::min<size_t>(front.second.size(), (size_t)cap);
  std::memcpy(buf, front.second.data(), (size_t)n);
  e->ctrl.pop_front();
  return n;
}

// r12 lifecycle quiesce: stop/resume NEW data production on the sender
// (the Engine::paused struct comment). ACKs, go-back-N retransmission,
// control traffic and drained-link FRESH beats keep running — the cluster
// consistent-cut barrier (comm/peer.py) drains every in-flight ledger to
// empty under this flag before any shard is captured.
__attribute__((visibility("default"))) void st_engine_pause(void* h,
                                                            int32_t p) {
  if (!h) return;
  auto* e = (Engine*)h;
  e->paused.store(p != 0);
  e->wake();
  if (p) {
    // SYNCHRONOUS pause: a sender pass that began before the store may
    // still be quantizing pre-pause residual state into the sendq. Wait
    // for two pass boundaries (the in-flight pass finishing + one full
    // pass that observed the flag), so by return NO data message produced
    // from pre-pause state can be enqueued after the caller's barrier
    // marker. Bounded (2 s) so a stopped/stuck sender can't wedge the
    // caller — the barrier's own quiesce gate still protects the capture.
    uint64_t g0 = e->sender_pass.load();
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::seconds(2);
    while (!e->stop.load() && e->sender_pass.load() < g0 + 2 &&
           std::chrono::steady_clock::now() < deadline) {
      e->wake();
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  }
}

// Checkpoint restore: replace the replica and the residuals of links that
// exist both in the engine and in the checkpoint, atomically (the inverse
// of st_engine_snapshot_ex; utils/checkpoint.load_shared). ``aux``
// (nullable — 4 u64 per link, the snapshot_ex layout) restores each
// surviving link's precision-governor state: wire precision (byte 0 of
// aux[2]) and previous-RMS sample (aux[3], bit-cast double), with the
// vote counters reset — the governor resumes from the checkpointed
// verdict instead of a cold start. Live links' tx/rx wire seqs are NEVER
// touched: the TCP streams they count are live and their counters moved
// on — resetting them to checkpoint values would open a seq gap the
// go-back-N machinery reads as a retransmission storm / black hole. The
// quiesce barrier makes this sound: ledgers are drained empty before a
// cluster restore, so both ends of every link agree without seq surgery
// (the checkpointed seqs are persisted for the manifest's consistency
// audit, not for replay).
__attribute__((visibility("default"))) void st_engine_restore_ex(
    void* h, const float* values, int32_t n_links, const int32_t* ids,
    const float* resids, const uint64_t* aux /* nullable */) {
  if (!h) return;
  auto* e = (Engine*)h;
  {
    StLockGuard lk(e->mu);
    fold_pending(e);  // pre-restore adds belong to the superseded state
    std::memcpy(e->values.data(), values, (size_t)e->total * 4);
    for (int32_t i = 0; i < n_links; i++) {
      if (ids[i] == -1) {  // the carry pseudo-slot (snapshot_ex)
        e->carry.assign((size_t)e->total, 0.0f);
        std::memcpy(e->carry.data(), resids + (size_t)i * e->total,
                    (size_t)e->total * 4);
        e->has_carry = true;
        continue;
      }
      auto it = e->links.find(ids[i]);
      if (it == e->links.end()) continue;
      ELink& l = it->second;
      std::memcpy(l.resid.data(), resids + (size_t)i * e->total,
                  (size_t)e->total * 4);
      l.dirty = true;
      l.pvalid = false;  // restore bypasses the fused kernels
      if (aux) {
        int prec = (int)(aux[(size_t)i * 4 + 2] & 0xFF);
        if (prec == 1 || prec == 2) l.prec = prec;
        uint64_t gb = aux[(size_t)i * 4 + 3];
        double gp;
        std::memcpy(&gp, &gb, 8);
        if (std::isfinite(gp)) l.gov_prev = gp;  // -1.0 sentinel included
        l.gov_up = l.gov_down = 0;
        l.gov_quiet = 0;
        l.gov_bp = 0;
      }
    }
  }
  ((Engine*)h)->wake();
}

__attribute__((visibility("default"))) void st_engine_restore(
    void* h, const float* values, int32_t n_links, const int32_t* ids,
    const float* resids) {
  st_engine_restore_ex(h, values, n_links, ids, resids, nullptr);
}

// Consistent point-in-time (values, residuals, link aux) snapshot under
// ONE lock — the checkpoint primitive (core.SharedTensor.snapshot_all).
// resid_out must hold max_links * total floats; aux_out (nullable) holds
// 4 u64 per link: [0] tx wire seq (last DATA/BURST sent), [1] rx count
// (last in-order wire seq accepted == the cumulative ACK value), [2] the
// link's wire precision in byte 0 with flag bits at 8+ (bit 8 subscriber,
// bit 9 peer-sign2-capable, bit 10 ranged), [3] the governor's previous
// RMS sample bit-cast from double. One mutex acquisition makes the
// capture atomic against the codec threads: a cascade quantize runs
// entirely under e->mu, so sign2 residual planes and in-flight ledgered
// frames can never tear the snapshot (tests/test_checkpoint.py pins the
// byte-exact round trip). Returns the number of links written.
__attribute__((visibility("default"))) int32_t st_engine_snapshot_ex(
    void* h, float* values_out, int32_t* ids_out, float* resid_out,
    uint64_t* aux_out /* nullable */, int32_t max_links) {
  if (!h) return 0;
  auto* e = (Engine*)h;
  StLockGuard lk(e->mu);
  fold_pending(e);
  std::memcpy(values_out, e->values.data(), (size_t)e->total * 4);
  int32_t n = 0;
  for (auto& kv : e->links) {
    if (n >= max_links) break;
    ELink& l = kv.second;
    ids_out[n] = kv.first;
    std::memcpy(resid_out + (size_t)n * e->total, l.resid.data(),
                (size_t)e->total * 4);
    if (aux_out) {
      uint64_t* a = aux_out + (size_t)n * 4;
      a[0] = l.tx_seq;
      a[1] = l.rx_count;
      uint64_t flags = (l.subscriber ? 1u : 0u) | (l.peer_sign2 ? 2u : 0u) |
                       (l.ranged ? 4u : 0u);
      a[2] = (uint64_t)(l.prec & 0xFF) | (flags << 8);
      double gp = l.gov_prev;
      uint64_t gb;
      std::memcpy(&gb, &gp, 8);
      a[3] = gb;
    }
    n++;
  }
  if (e->has_carry && n < max_links) {
    // the carry is owed state: persist it as pseudo-link -1 (restore
    // recognizes the id)
    ids_out[n] = -1;
    std::memcpy(resid_out + (size_t)n * e->total, e->carry.data(),
                (size_t)e->total * 4);
    if (aux_out) std::memset(aux_out + (size_t)n * 4, 0, 32);
    n++;
  }
  return n;
}

__attribute__((visibility("default"))) int32_t st_engine_snapshot_all(
    void* h, float* values_out, int32_t* ids_out, float* resid_out,
    int32_t max_links) {
  return st_engine_snapshot_ex(h, values_out, ids_out, resid_out, nullptr,
                               max_links);
}

// ---- r17 engine-tier shard data plane ABI ---------------------------------

// Standalone slice-codec kernels (the parity surface): one quantize /
// apply step over a word range of the global layout, exactly
// state.SliceCodec's semantics. tests/test_shard_engine.py pins byte
// equality against the numpy twin on shared random state; the python
// tier itself stays numpy (the reference), so these exist for the plane
// and the tests, not as a codec fast path for state.py.
__attribute__((visibility("default"))) int32_t st_slice_quantize(
    const int64_t* off, const int64_t* ns, const int64_t* padded,
    int64_t n_leaves, int64_t word_lo, int64_t word_cnt, int32_t policy,
    float* resid, float* scales, uint32_t* words) {
  ShardPlane p;
  p.L = n_leaves;
  p.off.assign(off, off + n_leaves);
  p.ns.assign(ns, ns + n_leaves);
  p.padded.assign(padded, padded + n_leaves);
  p.policy = policy;
  p.recv_cap = 1 << 20;
  int64_t wl = word_lo, wc = word_cnt;
  shard_geom_init(&p, &wl, &wc, 1);
  return slice_quantize(&p, p.geom[0], resid, scales, words) ? 1 : 0;
}

__attribute__((visibility("default"))) int32_t st_slice_apply(
    const int64_t* off, const int64_t* ns, const int64_t* padded,
    int64_t n_leaves, int64_t word_lo, int64_t word_cnt, float* target,
    const float* scales, const uint32_t* words) {
  ShardPlane p;
  p.L = n_leaves;
  p.off.assign(off, off + n_leaves);
  p.ns.assign(ns, ns + n_leaves);
  p.padded.assign(padded, padded + n_leaves);
  p.recv_cap = 1 << 20;
  int64_t wl = word_lo, wc = word_cnt;
  shard_geom_init(&p, &wl, &wc, 1);
  return slice_apply(&p, p.geom[0], target, scales, words) ? 1 : 0;
}

// The pump's whole message build as a standalone kernel (the cascade
// parity surface): up to k frames written at wire strides into `frames`
// (frame f's global scale row at f*per, word plane at f*per + 4L; per =
// 4*n_leaves + 4*word_cnt). Returns the frame count; error feedback
// lands in `resid` in place. tests/test_shard_engine.py pins byte
// equality against state.py's measure + cascade_rows + quantize_at on
// shared random state.
__attribute__((visibility("default"))) int32_t st_slice_cascade(
    const int64_t* off, const int64_t* ns, const int64_t* padded,
    int64_t n_leaves, int64_t word_lo, int64_t word_cnt, int32_t policy,
    int32_t k, float* resid, uint8_t* frames) {
  ShardPlane p;
  p.L = n_leaves;
  p.off.assign(off, off + n_leaves);
  p.ns.assign(ns, ns + n_leaves);
  p.padded.assign(padded, padded + n_leaves);
  p.policy = policy;
  p.recv_cap = 1 << 20;
  int64_t wl = word_lo, wc = word_cnt;
  shard_geom_init(&p, &wl, &wc, 1);
  ShardScratch scr;
  size_t per = (size_t)n_leaves * 4 + (size_t)word_cnt * 4;
  return slice_cascade_message(&p, p.geom[0], resid, k, frames, per, scr);
}

// Create the plane. `wlo`/`wcnt` carry every shard's word range (the r16
// fixed-at-creation partition — python's ShardMap mirrors the same
// deterministic geometry). `recv_cap` is wire.frame_wire_bytes(spec):
// the per-message FWD burst cap derives from it exactly like
// wire.fwd_frames_cap. `origin` is the node's obs id — the end-to-end
// (origin, fwd_seq) identity's first half.
__attribute__((visibility("default"))) void* st_shard_create(
    void* node, const int64_t* off, const int64_t* ns, const int64_t* padded,
    int64_t n_leaves, int64_t total, int64_t total_n, int32_t n_shards,
    const int64_t* wlo, const int64_t* wcnt, int32_t policy,
    int32_t recv_cap, double ack_timeout_sec, int32_t ack_retry_limit,
    int32_t park_cap, uint32_t origin) {
  if (!node || n_shards <= 0) return nullptr;
  auto* p = new ShardPlane();
  p->node = node;
  p->obs_id = st_node_obs_id(node);
  p->origin = origin;
  p->L = n_leaves;
  p->total = total;
  p->total_n = total_n;
  p->W = total / 32;
  p->off.assign(off, off + n_leaves);
  p->ns.assign(ns, ns + n_leaves);
  p->padded.assign(padded, padded + n_leaves);
  p->policy = policy;
  p->recv_cap = recv_cap;
  p->ack_timeout = ack_timeout_sec > 0 ? ack_timeout_sec : 0.0;
  p->ack_retry_limit = ack_retry_limit > 0 ? ack_retry_limit : 1;
  p->park_cap = park_cap > 0 ? park_cap : 4096;
  shard_geom_init(p, wlo, wcnt, n_shards);
  size_t widest = 0;
  for (auto& g : p->geom) {
    size_t per = (size_t)p->L * 4 + (size_t)g.wcnt * 4;
    size_t need = (size_t)g.kcap * per;
    if (need > widest) widest = need;
  }
  p->txpool.slot_bytes = kBodyOff + widest;
  return p;
}

__attribute__((visibility("default"))) void st_shard_start(void* h) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  if (p->started) return;
  p->started = true;
  p->send_thread = std::thread(shard_sender_loop, p);
  p->recv_thread = std::thread(shard_recv_loop, p);
}

__attribute__((visibility("default"))) void st_shard_stop(void* h) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  p->stop.store(true);
  p->wake();
  if (p->send_thread.joinable()) p->send_thread.join();
  if (p->recv_thread.joinable()) p->recv_thread.join();
}

__attribute__((visibility("default"))) void st_shard_destroy(void* h) {
  auto* p = (ShardPlane*)h;
  if (!p) return;
  // drop ledger references (no rollback — FWD mass re-dispatches at
  // detach; a dying plane has nothing left to repair)
  {
    StLockGuard lk(p->mu);
    for (auto& kv : p->members) {
      for (auto& e : kv.second.unacked) shard_entry_unref(p, e);
      kv.second.unacked.clear();
    }
  }
  // wait for in-flight transport release callbacks (TxSlots AND taken rx
  // buffers) to drain — the st_engine_destroy rationale, verbatim
  for (int i = 0;; i++) {
    bool busy = p->taken_live.load(std::memory_order_acquire) != 0;
    if (!busy) {
      StLockGuard lk(p->txpool.mu);
      for (auto& s : p->txpool.all_)
        if (s->refs.load(std::memory_order_acquire) != 0) {
          busy = true;
          break;
        }
    }
    if (!busy) break;
    if (i >= 2000) return;  // ~2 s: leak rather than free under a live thread
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  delete p;
}

// Attach a member link (handshake complete — python's WELCOME exchange).
// The plane's receiver owns the link's stream from here: FWD/ACK are
// consumed natively, everything else defers to st_shard_poll_ctrl.
__attribute__((visibility("default"))) int32_t st_shard_member_attach(
    void* h, int32_t link, uint64_t tx_init, uint64_t rx_init) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  if (p->members.count(link)) return 0;
  SMember m;
  m.tx_seq = tx_init;
  m.rx_count = rx_init;
  m.ack_sent = rx_init;
  m.ack_progress = EClock::now();
  p->members.emplace(link, std::move(m));
  return 1;
}

// Detach a member (LINK_DOWN): every unacked FWD re-dispatches under its
// UNCHANGED end-to-end identity — a copy that was actually delivered dies
// in the owner's dedup window instead of double-applying (node.py
// _on_link_down's discipline). Routeless frames park.
__attribute__((visibility("default"))) int32_t st_shard_member_detach(
    void* h, int32_t link) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  std::deque<ShardSent> entries;
  {
    StLockGuard lk(p->mu);
    auto it = p->members.find(link);
    if (it == p->members.end()) return 0;
    entries.swap(it->second.unacked);
    p->members.erase(it);
    if (p->uplink == link) p->uplink = -1;
    for (auto rit = p->route.begin(); rit != p->route.end();) {
      if (rit->second == link)
        rit = p->route.erase(rit);
      else
        ++rit;
    }
  }
  std::vector<float> ss;
  std::vector<uint32_t> ws;
  for (auto& e : entries) {
    const uint8_t* d = e.slot ? e.slot->buf.data() + e.slot->wire_off
                              : e.taken->data;
    uint32_t n = e.slot ? e.slot->wire_len : e.taken->len;
    uint32_t wlo;
    std::memcpy(&wlo, d + 5, 4);
    int32_t shard = shard_of_word(p, wlo);
    if (shard < 0) {
      shard_entry_unref(p, e);
      continue;
    }
    if (!shard_dispatch(p, shard, e.slot, e.taken,
                        const_cast<uint8_t*>(d), n, -1, ss, ws)) {
      StLockGuard lk(p->mu);
      shard_park(p, shard, d, n);
      shard_entry_unref(p, e);
    }
  }
  p->wake();
  return 1;
}

__attribute__((visibility("default"))) void st_shard_set_uplink(
    void* h, int32_t link) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  {
    StLockGuard lk(p->mu);
    p->uplink = link;
  }
  p->wake();
}

// Routes are Python's call (the own-announce flood stays control-plane);
// the plane mirrors them for the relay/pump hop choice. link < 0 clears.
__attribute__((visibility("default"))) void st_shard_set_route(
    void* h, int32_t shard, int32_t link) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  {
    StLockGuard lk(p->mu);
    if (link < 0)
      p->route.erase(shard);
    else
      p->route[shard] = link;
  }
  p->wake();  // parked frames may have a route now
}

// Mark a shard's outgoing handoff in flight (the _ho_sent discipline):
// while set, FWDs for it relay toward the successor instead of applying
// to the already-shipped slice (debited-mass conservation — the
// spec_shard apply_during_handoff mutation).
__attribute__((visibility("default"))) void st_shard_set_handoff(
    void* h, int32_t shard, int32_t on) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  if (on)
    p->ho_sent.insert(shard);
  else
    p->ho_sent.erase(shard);
}

// Adopt a shard slice (grant / handoff / restore). `values` NULL seeds
// zeros. Any outbox held toward the shard folds straight into the slice
// (we ARE the owner now — exact local apply), under the same mutex.
__attribute__((visibility("default"))) void st_shard_adopt(
    void* h, int32_t shard, const float* values) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  {
    StLockGuard lk(p->mu);
    if (shard < 0 || (size_t)shard >= p->geom.size()) return;
    const ShardGeom& g = p->geom[(size_t)shard];
    auto& vals = p->owned[shard];
    vals.assign((size_t)g.n_el, 0.0f);
    if (values) std::memcpy(vals.data(), values, (size_t)g.n_el * 4);
    auto ob = p->outbox.find(shard);
    if (ob != p->outbox.end()) {
      for (int64_t j = 0; j < g.n_el; j++) {
        float t = vals[(size_t)j] + ob->second[(size_t)j];
        if (t > kSat) t = kSat;
        if (t < -kSat) t = -kSat;
        vals[(size_t)j] = t;
      }
      p->outbox.erase(ob);
    }
    p->route.erase(shard);
    p->ho_sent.erase(shard);
  }
  p->wake();  // parked frames for this shard can apply now
}

// Release ownership (handoff tail / takeover re-grant). Returns 1 and
// copies the slice into `out` (when non-NULL) if it was owned.
__attribute__((visibility("default"))) int32_t st_shard_release(
    void* h, int32_t shard, float* out) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  auto it = p->owned.find(shard);
  if (it == p->owned.end()) return 0;
  if (out) std::memcpy(out, it->second.data(), it->second.size() * 4);
  p->owned.erase(it);
  p->ho_sent.erase(shard);
  return 1;
}

__attribute__((visibility("default"))) int32_t st_shard_owns(
    void* h, int32_t shard) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  return p->owned.count(shard) ? 1 : 0;
}

// Copy one owned slice out (serve-tier reads, handoff state chunks).
__attribute__((visibility("default"))) int32_t st_shard_read(
    void* h, int32_t shard, float* out) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  auto it = p->owned.find(shard);
  if (it == p->owned.end()) return 0;
  std::memcpy(out, it->second.data(), it->second.size() * 4);
  return 1;
}

// Merge an additive update (node.py add()'s hot half): the in-shard part
// applies EXACTLY to the owned slices, every out-of-shard part
// accumulates into its target shard's outbox residual — one mutex, like
// state.add_delta, so a racing adopt can never strand a deposit.
// `flat` is the full padded flat delta (spec.total floats).
__attribute__((visibility("default"))) void st_shard_add(
    void* h, const float* flat) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  {
    StLockGuard lk(p->mu);
    for (size_t s = 0; s < p->geom.size(); s++) {
      const ShardGeom& g = p->geom[s];
      const float* seg = flat + g.elo;
      bool nz = false;
      for (int64_t j = 0; j < g.n_el; j++)
        if (seg[j] != 0.0f) {
          nz = true;
          break;
        }
      if (!nz) continue;
      auto oit = p->owned.find((int32_t)s);
      if (oit != p->owned.end()) {
        float* vals = oit->second.data();
        for (int64_t j = 0; j < g.n_el; j++) {
          float t = vals[j] + seg[j] * g.live[(size_t)j];
          if (t > kSat) t = kSat;
          if (t < -kSat) t = -kSat;
          vals[j] = t;
        }
      } else {
        auto& ob = p->outbox[(int32_t)s];
        if (ob.empty()) ob.assign((size_t)g.n_el, 0.0f);
        float* r = ob.data();
        for (int64_t j = 0; j < g.n_el; j++)
          r[j] += seg[j] * g.live[(size_t)j];
      }
    }
  }
  p->updates++;
  p->wake();
}

// Re-seat a checkpointed outbox residual (restart path) — added to any
// mass already accumulated, like state.restore_outbox.
__attribute__((visibility("default"))) void st_shard_restore_outbox(
    void* h, int32_t shard, const float* resid) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  {
    StLockGuard lk(p->mu);
    if (shard < 0 || (size_t)shard >= p->geom.size()) return;
    const ShardGeom& g = p->geom[(size_t)shard];
    auto& ob = p->outbox[shard];
    if (ob.empty()) ob.assign((size_t)g.n_el, 0.0f);
    for (int64_t j = 0; j < g.n_el; j++) ob[(size_t)j] += resid[j];
  }
  p->wake();
}

// Merge (origin, seqs) into the end-to-end dedup window (handoff /
// restore) — sorted-merge + window trim, byte-compatible with node.py's
// _on_ho merge so mixed-tier handoffs interop.
__attribute__((visibility("default"))) int32_t st_shard_dedup_merge(
    void* h, uint32_t origin, const uint64_t* seqs, int64_t n) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  auto& win = p->dedup[origin];
  for (int64_t i = 0; i < n; i++) win.first.insert((uint32_t)seqs[i]);
  win.second.assign(win.first.begin(), win.first.end());  // sorted merge
  while (win.second.size() > kShardDedupWindow) {
    win.first.erase(win.second.front());
    win.second.pop_front();
  }
  return 1;
}

// Atomic checkpoint capture — owned slices, outbox residuals and dedup
// windows under ONE mutex acquisition (the r16 fourth-review invariant:
// a window seq must never persist without its applied mass). Returns the
// owned-slice count; ids/values land in ascending shard order, values
// concatenated (the caller knows each shard's n_el from the map
// geometry). `dd_n`/`n_ob` receive the dedup pair count and outbox count.
__attribute__((visibility("default"))) int32_t st_shard_snapshot(
    void* h, int32_t* owned_ids, float* owned_vals, int32_t* outbox_ids,
    float* outbox_vals, uint32_t* dd_origins, uint64_t* dd_seqs,
    int64_t dd_cap, int64_t* dd_n, int32_t* n_ob) {
  *dd_n = 0;
  *n_ob = 0;
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  int32_t no = 0;
  size_t voff = 0;
  for (auto& kv : p->owned) {
    owned_ids[no++] = kv.first;
    std::memcpy(owned_vals + voff, kv.second.data(), kv.second.size() * 4);
    voff += kv.second.size();
  }
  int32_t nb = 0;
  voff = 0;
  for (auto& kv : p->outbox) {
    outbox_ids[nb++] = kv.first;
    std::memcpy(outbox_vals + voff, kv.second.data(), kv.second.size() * 4);
    voff += kv.second.size();
  }
  *n_ob = nb;
  int64_t dn = 0;
  for (auto& kv : p->dedup)
    for (uint32_t s : kv.second.second) {
      if (dn >= dd_cap) break;
      dd_origins[dn] = kv.first;
      dd_seqs[dn] = s;
      dn++;
    }
  *dd_n = dn;
  return no;
}

// Total (origin, fwd_seq) pairs across every dedup window — sizes the
// export/snapshot buffers so a many-origin cluster's windows never
// silently truncate (each origin holds at most kShardDedupWindow).
__attribute__((visibility("default"))) int64_t st_shard_dedup_size(void* h) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  int64_t n = 0;
  for (auto& kv : p->dedup) n += (int64_t)kv.second.second.size();
  return n;
}

// Export the dedup windows alone (the handoff ride-along: per-origin
// state, no reason to copy every owned slice the way st_shard_snapshot
// must). Returns the pair count written (<= cap).
__attribute__((visibility("default"))) int64_t st_shard_dedup_export(
    void* h, uint32_t* origins, uint64_t* seqs, int64_t cap) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  int64_t dn = 0;
  for (auto& kv : p->dedup)
    for (uint32_t s : kv.second.second) {
      if (dn >= cap) return dn;
      origins[dn] = kv.first;
      seqs[dn] = s;
      dn++;
    }
  return dn;
}

__attribute__((visibility("default"))) uint32_t st_shard_fwd_seq(void* h) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  return p->fwd_seq;
}

__attribute__((visibility("default"))) void st_shard_set_fwd_seq(
    void* h, uint32_t seq) {
  if (!h) return;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  p->fwd_seq = seq;
}

// Resident f32 state bytes (owned slices + live outboxes): the chaos
// harness's per-node bound (subscriber residuals stay python-side and
// are added there).
__attribute__((visibility("default"))) int64_t st_shard_alloc_bytes(
    void* h) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  int64_t total = 0;
  for (auto& kv : p->owned) total += (int64_t)kv.second.size() * 4;
  for (auto& kv : p->outbox) total += (int64_t)kv.second.size() * 4;
  return total;
}

__attribute__((visibility("default"))) int64_t st_shard_outbox_bytes(
    void* h) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  int64_t total = 0;
  for (auto& kv : p->outbox) total += (int64_t)kv.second.size() * 4;
  return total;
}

__attribute__((visibility("default"))) int64_t st_shard_owned_words(
    void* h) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  int64_t total = 0;
  for (auto& kv : p->owned)
    total += p->geom[(size_t)kv.first].wcnt;
  return total;
}

// True when every outbox residual is within tol of idle AND every ledger
// is empty AND nothing is parked — node.py drained()'s engine half.
__attribute__((visibility("default"))) int32_t st_shard_idle(void* h,
                                                             double tol) {
  if (!h) return 1;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->mu);
  if (!p->parked.empty()) return 0;
  for (auto& kv : p->members)
    if (!kv.second.unacked.empty()) return 0;
  for (auto& kv : p->outbox)
    for (float v : kv.second)
      if (std::fabs(v) > tol) return 0;
  return 1;
}

// Counter snapshot:
// [0 fwd_msgs_out, 1 fwd_msgs_in, 2 relayed, 3 dedup_discards,
//  4 park_drops, 5 parked (gauge), 6 retx_msgs, 7 updates,
//  8 fwd_frames_out, 9 fwd_frames_in, 10 tx_slot_acquires,
//  11 tx_slot_alloc_events, 12 fwd_undecodable, 13 inflight (gauge)]
__attribute__((visibility("default"))) void st_shard_counters(
    void* h, uint64_t* out14) {
  for (int i = 0; i < 14; i++) out14[i] = 0;
  if (!h) return;
  auto* p = (ShardPlane*)h;
  out14[0] = p->fwd_msgs_out.load();
  out14[1] = p->fwd_msgs_in.load();
  out14[2] = p->relayed.load();
  out14[3] = p->dedup_discards.load();
  out14[4] = p->park_drops.load();
  out14[6] = p->retx_msgs.load();
  out14[7] = p->updates.load();
  out14[8] = p->fwd_frames_out.load();
  out14[9] = p->fwd_frames_in.load();
  out14[10] = p->txpool.acquires.load();
  out14[11] = p->txpool.alloc_events.load();
  out14[12] = p->fwd_undecodable.load();
  uint64_t parked_n = 0, inflight = 0;
  {
    StLockGuard lk(p->mu);
    parked_n = (uint64_t)p->parked.size();
    for (auto& kv : p->members) inflight += (uint64_t)kv.second.unacked.size();
  }
  out14[5] = parked_n;
  out14[13] = inflight;
}

// Pop one control-plane message the receiver deferred to Python (same
// contract as st_engine_poll_ctrl).
__attribute__((visibility("default"))) int32_t st_shard_poll_ctrl(
    void* h, int32_t* link_out, uint8_t* buf, int32_t cap) {
  if (!h) return 0;
  auto* p = (ShardPlane*)h;
  StLockGuard lk(p->cmu);
  if (p->ctrl.empty()) return 0;
  auto& front = p->ctrl.front();
  *link_out = front.first;
  int32_t n = (int32_t)std::min<size_t>(front.second.size(), (size_t)cap);
  std::memcpy(buf, front.second.data(), (size_t)n);
  p->ctrl.pop_front();
  return n;
}

}  // extern "C"
