/* stcodec: native host-tier codec hot loops.
 *
 * The reference's entire codec is ~30 lines of C inside its link threads
 * (reference src/sharedtensor.c:106-111 receiver, :153-174 sender), measured
 * at 202 M elem/s on one core (BASELINE.md) — the system's bottleneck. Our
 * host tier's numpy implementation (ops/codec_np.py) costs ~8 memory passes
 * per frame where the C loop needs ~2 fused ones; this library provides
 * those fused loops for CPU peers. The TPU tier is ops/codec_pallas.py; the
 * numpy tier remains the always-available fallback and the semantic
 * reference for these functions (bit-identical given the same scales).
 *
 * Table layout (ops/table.py): one flat f32 buffer; leaf i occupies
 * [off[i], off[i]+padded[i]) with ns[i] live elements at the front, padding
 * exactly 0. Bits are LSB-first: flat bit j -> word[j/32] bit j%32
 * (ops/packing.py wire contract; byte-identical to the reference's
 * data[i/8] |= 1 << (i%8)).
 *
 * Plain C ABI for ctypes (no pybind11 in this image).
 *
 * Threading: each entry point runs serial below ST_CODEC_PAR_MIN elements
 * (one link engine per thread, like the reference — small tables are
 * latency-bound and a pool handoff would only add wakeup cost). Above the
 * threshold the loops run chunked on a small process-wide worker pool
 * (stc_pool below): chunks are fixed 2 Mi-element word-aligned ranges, so
 * reduction grouping — and therefore every scale partial — is a pure
 * function of the table layout, NOT of the thread count; results are
 * deterministic for any ST_CODEC_THREADS value, differing from the serial
 * pass only by the ~1-ulp summation-order tolerance every scale consumer
 * already accepts (scales ride the wire, receivers never recompute them).
 * Elementwise loops (quantize/apply/add) are bit-exact under any split.
 */

#include <stdint.h>
#include <string.h>

#include "st_annotations.h" /* clang -Wthread-safety vocabulary (no-op on gcc) */

#define EXPORT __attribute__((visibility("default")))

/* AVX-512 fast paths with RUNTIME dispatch. The reference's scalar loops run
 * ~200 M elem/s/core (BASELINE.md); the sign-quantize and apply loops below
 * are 1-bit-per-float mask ops, which AVX-512 expresses directly
 * (compare->__mmask16 is the codec's bitmask, bit-for-bit). Scalar code
 * stays as the portable fallback and the semantic reference.
 *
 * Why runtime and not -march=native: a prebuilt libstcodec.so can travel to
 * another machine (docker image, rsync'd checkout, NFS) where make's
 * mtime-only check sees it as fresh — compile-time-only AVX-512 would then
 * SIGILL the peer process on a non-AVX-512 host. The AVX-512 bodies are
 * compiled via __attribute__((target(...))) and selected per-process with
 * __builtin_cpu_supports, so the same .so is correct everywhere. */
#if defined(__x86_64__) && defined(__GNUC__) && !defined(ST_ANALYZE_NO_SIMD)
#include <immintrin.h>
#define ST_AVX512 1
static int st_has_avx512(void) {
  /* relaxed atomics (TSan arm finding): two engine threads can run the
   * first large-table kernels concurrently, and the lazy init of a plain
   * int was a write/read race. Both writers store the same value, so
   * relaxed ordering is sufficient — the guard is the access atomicity. */
  static int cached = -1;
  int c = __atomic_load_n(&cached, __ATOMIC_RELAXED);
  if (c < 0) {
    c = __builtin_cpu_supports("avx512f") &&
        __builtin_cpu_supports("avx512dq");
    __atomic_store_n(&cached, c, __ATOMIC_RELAXED);
  }
  return c;
}
#define ST_TARGET_AVX512 __attribute__((target("avx512f,avx512dq")))
/* The scalar loops are the only path on non-AVX-512 x86; without
 * -march=native they'd compile to baseline SSE2. target_clones gives them
 * an AVX2 auto-vectorized clone behind the same runtime-dispatch safety. */
#define ST_CLONES __attribute__((target_clones("avx2", "default")))
#else
#define ST_CLONES
#endif

/* ---- worker pool ---------------------------------------------------------
 *
 * One process-wide pool, lazily spawned on the first large-table call.
 * Thread count: ST_CODEC_THREADS env (<=1 disables), else min(nproc, 8).
 * Submitters serialize on job_mu with TRYLOCK: if the pool is busy (the
 * engine's sender and receiver threads can both hit large-table codec ops
 * concurrently) the second caller just runs its loop inline — never blocks,
 * never deadlocks. Workers pull chunk indices from one atomic counter.
 * Fork safety: Python peers fork worker processes (multiprocessing); pool
 * threads do not survive fork, so an atfork child handler marks the pool
 * dead and every later call in the child runs inline (correct, just
 * serial) until nothing — the child can never wait on absent workers. */
#if defined(__unix__)
#define ST_POOL 1
#include <pthread.h>
#include <stdatomic.h>
#include <stdlib.h>
#include <unistd.h>

/* chunk granularity: 128 Ki elements = 512 KiB of f32 (multiple of 32, so
 * a chunk boundary never splits a packed word); parallel threshold below.
 * r07: was 2 Mi / 4 Mi — that left every table below 4 Mi elements (the
 * 1 Mi headline bench among them) single-threaded; 512 KiB chunks keep
 * the per-chunk work far above the pool handoff cost (~µs vs ~50 µs of
 * memory traffic) while letting mid-size tables use the pool. The
 * decomposition stays a pure function of the layout (NOT of the thread
 * count), so partials grouping remains deterministic for any
 * ST_CODEC_THREADS — only the grouping constant changed, moving scale
 * partials within the same ~1-ulp summation-order tolerance the tier
 * contract already accepts. */
#define ST_CHUNK_ELEMS ((int64_t)128 * 1024)
#define ST_PAR_MIN_ELEMS ((int64_t)256 * 1024)

/* Bounded spin (in pause-loop iterations) a worker burns watching for the
 * next job before it blocks on the condvar, and the submitter burns
 * watching for completion before it blocks on cv_done. The steady-state
 * burst loop submits one quantize job per frame back-to-back (~0.1-0.3 ms
 * apart at 1 Mi); a condvar sleep/wake on every one of those costs tens of
 * µs per worker per job — comparable to the per-chunk work itself at 512 KiB
 * chunks, which is exactly why the old 2 Mi chunking saw no speedup below
 * 4 Mi elements. The spin window catches the back-to-back case; an idle
 * process pays it once per quiesce, then sleeps as before. */
#define ST_SPIN_ITERS 20000

#if defined(__x86_64__)
#define stc_cpu_relax() __builtin_ia32_pause()
#else
#define stc_cpu_relax() ((void)0)
#endif

typedef void (*stc_seg_fn)(void *ctx, int64_t seg);

/* pthread_mutex_t wrapped as a clang thread-safety "capability" so pool
 * fields can carry ST_GUARDED_BY and the analysis checks the lock
 * discipline (st_annotations.h; plain pthread types are not capabilities).
 * Lock order: job_mu -> mu (the submitter wakes sleepers / sleeps on
 * cv_done while holding job_mu); workers take mu alone. */
typedef struct ST_CAPABILITY("mutex") stc_mutex {
  pthread_mutex_t m;
} stc_mutex_t;

/* The wrapper BODIES are the trusted primitive — pthread_mutex_* is not
 * annotated, so without the no-analysis escape the analysis flags the
 * acquire/release contract as unfulfilled inside each wrapper. Callers
 * still get the full contract from the attributes. */
static inline void stc_mutex_lock(stc_mutex_t *mu)
    ST_ACQUIRE(*mu) ST_NO_THREAD_SAFETY_ANALYSIS {
  pthread_mutex_lock(&mu->m);
}
static inline void stc_mutex_unlock(stc_mutex_t *mu)
    ST_RELEASE(*mu) ST_NO_THREAD_SAFETY_ANALYSIS {
  pthread_mutex_unlock(&mu->m);
}
/* returns 0 on success, like pthread_mutex_trylock */
static inline int stc_mutex_trylock(stc_mutex_t *mu)
    ST_TRY_ACQUIRE(0, *mu) ST_NO_THREAD_SAFETY_ANALYSIS {
  return pthread_mutex_trylock(&mu->m);
}

static struct {
  stc_mutex_t mu;
  pthread_cond_t cv_job, cv_done;
  stc_mutex_t job_mu; /* serializes submitters (trylock) */
  /* 0 = not yet, 1 = live, -1 = dead (fork child / threading disabled).
   * ATOMIC: stc_pool_up's fast path reads it lock-free on every
   * large-table call (a plain int there was a data race against the
   * slow path's locked write — exactly the bug class this PR's TSan arm
   * exists to catch; the transition is monotonic 0 -> {1,-1} so the
   * value a racy reader observes is still always valid). */
  _Atomic int started;
  int nworkers ST_GUARDED_BY(mu);
  uint64_t gen ST_GUARDED_BY(job_mu);
  /* job fields are relaxed atomics published under the agen seqlock (see
   * below): plain fields raced the next submitter's writes once the
   * publish mutex was dropped — a worker preempted between adopting agen
   * and reading nseg could pair job N's counter tag with job N+1's nseg
   * and claim a chunk both jobs then process. */
  _Atomic(stc_seg_fn) fn;
  void *_Atomic ctx;
  _Atomic int64_t nseg;
  /* generation-tagged work counter: (gen & 0xffffffff) << 32 | next_index.
   * The tag closes a straggler race: a worker that woke for job G and
   * snapshotted fn/ctx/nseg can be preempted BEFORE its first pop while
   * the other threads finish all of G; the submitter then returns, frees
   * G's chunks (a stack ctx), and publishes job G+1 — an untagged counter
   * would hand the stale worker G+1's chunk indices to run with G's dead
   * fn/ctx (use-after-free) while G+1 silently loses those chunks. With
   * the tag, a pop whose generation no longer matches fails and the
   * straggler falls through to re-wait (ADVICE r05 finding 2). */
  _Atomic uint64_t next;
  /* r11 lock-free hot path: the per-job mutex round trips (publish
   * broadcast + every worker's start/finish acquisition) measured as
   * ~100 us of a ~250 us pass once the cascade cut the pass COUNT 8-fold
   * — the handoff became the wall. Steady state now touches no mutex at
   * all: agen is a SEQLOCK word, (gen << 1) | writing — the submitter
   * flips it odd (acq_rel RMW, so the field stores cannot hoist above
   * it), stores fn/ctx/nseg/afin/next, then release-stores the new even
   * tag; a worker snapshots the fields between two agen loads and
   * retries on odd or mismatch, so a snapshot is always ONE job's
   * consistent set and its pops tag-check against that same gen.
   * Workers count completions into afin, a single generation-tagged
   * (gen32 << 32 | finished) word the submitter spins on. The
   * mutex/condvar pair remains ONLY as the idle-sleep fallback: workers
   * register in `sleepers` and timed-wait (bounded, so the publisher's
   * racy sleepers check can never lose a wakeup for more than one
   * tick), and a submitter whose spin expires sets sub_waiting and
   * timed-waits on cv_done. */
  _Atomic uint64_t agen;
  _Atomic uint64_t afin; /* (gen32 << 32) | chunks finished for that gen */
  /* modified under mu (the condvar handshake needs that); ATOMIC because
   * the publisher reads it without mu — the missed-wakeup that read can
   * suffer is bounded by the 2 ms timedwait tick, but the access itself
   * must not be a plain-int data race */
  _Atomic int sleepers;
  _Atomic int sub_waiting;
} g_pool = {.mu = {PTHREAD_MUTEX_INITIALIZER},
            .cv_job = PTHREAD_COND_INITIALIZER,
            .cv_done = PTHREAD_COND_INITIALIZER,
            .job_mu = {PTHREAD_MUTEX_INITIALIZER}};

/* Pop one chunk index for generation `gen`, or -1 when the job is exhausted
 * OR the counter now belongs to a different generation (stale worker). */
static int64_t stc_pool_pop(uint64_t gen, int64_t nseg) {
  uint64_t cur = atomic_load(&g_pool.next);
  for (;;) {
    if ((uint32_t)(cur >> 32) != (uint32_t)gen) return -1; /* stale gen */
    int64_t s = (int64_t)(cur & 0xffffffffu);
    if (s >= nseg) return -1; /* job exhausted */
    /* on failure `cur` is refreshed; re-check gen before retrying */
    if (atomic_compare_exchange_weak(&g_pool.next, &cur, cur + 1)) return s;
  }
}

static void *stc_pool_worker(void *arg) {
  (void)arg;
  uint64_t seen = 0;
  for (;;) {
    /* spin phase: the steady-state sender submits jobs back-to-back, and
     * a condvar sleep/wake per job costs more than a whole 512 KiB chunk —
     * watch the lock-free generation mirror before sleeping. */
    int spun = 0;
    while (atomic_load_explicit(&g_pool.agen, memory_order_acquire) ==
           seen) {
      if (++spun >= ST_SPIN_ITERS) {
        /* idle: sleep (the only mutex on this thread's lifetime path).
         * timedwait bounds the publisher's racy sleepers check — a
         * publish that misses a just-registering sleeper costs one tick,
         * never a lost wakeup. */
        stc_mutex_lock(&g_pool.mu);
        g_pool.sleepers++;
        while (atomic_load_explicit(&g_pool.agen, memory_order_acquire) ==
               seen) {
          struct timespec ts;
          clock_gettime(CLOCK_REALTIME, &ts);
          ts.tv_nsec += 2000000; /* 2 ms tick */
          if (ts.tv_nsec >= 1000000000) {
            ts.tv_sec++;
            ts.tv_nsec -= 1000000000;
          }
          pthread_cond_timedwait(&g_pool.cv_job, &g_pool.mu.m, &ts);
        }
        g_pool.sleepers--;
        stc_mutex_unlock(&g_pool.mu);
        break;
      }
      stc_cpu_relax();
    }
    /* seqlock read: snapshot the job fields between two agen loads and
     * adopt only a stable, even (not mid-publish) tag — the snapshot is
     * then ONE job's consistent {fn, ctx, nseg}, and pops tag-check
     * against that same generation. A newer job replacing the counter
     * makes our pops fail and we loop to re-adopt (the straggler
     * discipline, ADVICE r05 finding 2 — unchanged, just lock-free). */
    uint64_t g1 = atomic_load_explicit(&g_pool.agen, memory_order_acquire);
    if ((g1 & 1) != 0 || g1 == seen) continue;
    stc_seg_fn fn = atomic_load_explicit(&g_pool.fn, memory_order_relaxed);
    void *ctx = atomic_load_explicit(&g_pool.ctx, memory_order_relaxed);
    int64_t nseg = atomic_load_explicit(&g_pool.nseg, memory_order_relaxed);
    atomic_thread_fence(memory_order_acquire);
    if (atomic_load_explicit(&g_pool.agen, memory_order_relaxed) != g1)
      continue; /* a publish raced the snapshot: re-adopt */
    seen = g1;
    uint64_t gen = g1 >> 1;
    int64_t done = 0;
    for (;;) {
      int64_t s = stc_pool_pop(gen, nseg);
      if (s < 0) break;
      fn(ctx, s);
      done++;
    }
    if (done) {
      /* generation-tagged completion: only count into OUR job's word (a
       * straggler of a finished job sees a mismatched tag and drops its
       * count — that job already completed without it). */
      uint64_t cur = atomic_load(&g_pool.afin);
      for (;;) {
        if ((uint32_t)(cur >> 32) != (uint32_t)gen) break;
        if (atomic_compare_exchange_weak(&g_pool.afin, &cur,
                                         cur + (uint64_t)done)) {
          if ((int64_t)((cur & 0xffffffffu) + (uint64_t)done) >= nseg &&
              atomic_load_explicit(&g_pool.sub_waiting,
                                   memory_order_acquire)) {
            stc_mutex_lock(&g_pool.mu);
            pthread_cond_broadcast(&g_pool.cv_done);
            stc_mutex_unlock(&g_pool.mu);
          }
          break;
        }
      }
    }
  }
  return NULL;
}

static void stc_pool_child(void) {
  /* fork child: single-threaded by definition, but keep the store atomic
   * so the field has exactly one access discipline everywhere */
  atomic_store_explicit(&g_pool.started, -1, memory_order_relaxed);
}

static int stc_pool_threads(void) {
  static int cached = 0;
  if (!cached) {
    const char *env = getenv("ST_CODEC_THREADS");
    long v = env ? strtol(env, NULL, 10) : 0;
    if (v <= 0) {
      long np = sysconf(_SC_NPROCESSORS_ONLN);
      v = np < 1 ? 1 : (np > 8 ? 8 : np);
    }
    cached = v > 64 ? 64 : (int)v;
  }
  return cached;
}

/* Ensure workers exist. Returns 0 when threading is unavailable. The
 * lock-free fast path is why `started` is atomic (its declaration): every
 * large-table codec call lands here first. */
static int stc_pool_up(void) {
  int st = atomic_load_explicit(&g_pool.started, memory_order_acquire);
  if (st == 1) return 1;
  if (st < 0) return 0;
  stc_mutex_lock(&g_pool.mu);
  if (atomic_load_explicit(&g_pool.started, memory_order_relaxed) == 0) {
    int nt = stc_pool_threads();
    if (nt <= 1) {
      atomic_store_explicit(&g_pool.started, -1, memory_order_release);
    } else {
      pthread_atfork(NULL, NULL, stc_pool_child);
      int spawned = 0;
      for (int i = 0; i < nt - 1; i++) { /* submitter participates */
        pthread_t t;
        if (pthread_create(&t, NULL, stc_pool_worker, NULL) == 0) {
          pthread_detach(t);
          spawned++;
        }
      }
      g_pool.nworkers = spawned;
      atomic_store_explicit(&g_pool.started, spawned > 0 ? 1 : -1,
                            memory_order_release);
    }
  }
  int ok = atomic_load_explicit(&g_pool.started, memory_order_relaxed) == 1;
  stc_mutex_unlock(&g_pool.mu);
  return ok;
}

/* Run fn(ctx, seg) for seg in [0, nseg) across the pool; the caller works
 * too. Returns 1 if the job ran on the pool, 0 if the caller must run the
 * whole loop inline (pool busy / dead / tiny job). */
static int stc_pool_run(stc_seg_fn fn, void *ctx, int64_t nseg) {
  if (nseg < 2 || nseg >= (int64_t)1 << 32 || !stc_pool_up()) return 0;
  if (stc_mutex_trylock(&g_pool.job_mu) != 0) return 0;
  /* job_mu serializes submitters, so gen is ours to bump; the fields
   * publish under the agen seqlock: odd tag first (the acq_rel RMW pins
   * the stores AFTER it), fields + tagged counters, then the new even
   * tag LAST (release) — a worker whose two agen reads bracket a stable
   * even value observed exactly this job's field set. */
  g_pool.gen++;
  uint64_t gen = g_pool.gen; /* ours until job_mu is released */
  atomic_fetch_add_explicit(&g_pool.agen, 1, memory_order_acq_rel);
  atomic_store_explicit(&g_pool.fn, fn, memory_order_relaxed);
  atomic_store_explicit(&g_pool.ctx, ctx, memory_order_relaxed);
  atomic_store_explicit(&g_pool.nseg, nseg, memory_order_relaxed);
  atomic_store_explicit(&g_pool.afin, (uint64_t)(uint32_t)gen << 32,
                        memory_order_relaxed);
  /* generation-tagged chunk counter (index 0): any straggler still
   * holding the previous gen can no longer pop from it */
  atomic_store(&g_pool.next, (uint64_t)(uint32_t)gen << 32);
  atomic_store_explicit(&g_pool.agen, gen << 1, memory_order_release);
  /* wake sleepers only when there are any: the unlocked read can miss a
   * JUST-registering sleeper, whose 2 ms timedwait tick re-checks agen —
   * bounded lag on an idle->busy edge, zero mutex traffic when hot */
  if (g_pool.sleepers > 0) {
    stc_mutex_lock(&g_pool.mu);
    pthread_cond_broadcast(&g_pool.cv_job);
    stc_mutex_unlock(&g_pool.mu);
  }
  int64_t done = 0;
  for (;;) {
    int64_t s = stc_pool_pop(gen, nseg);
    if (s < 0) break;
    fn(ctx, s);
    done++;
  }
  /* completion: count our own chunks in (plain add — the tag is ours by
   * construction and counts can never carry into it: total <= nseg <
   * 2^32), then spin-watch the tagged word before falling back to the
   * condvar sleep — the tail chunk usually lands within a few us. */
  uint64_t fin_word =
      atomic_fetch_add(&g_pool.afin, (uint64_t)done) + (uint64_t)done;
  if ((int64_t)(fin_word & 0xffffffffu) < nseg) {
    int waited = 0;
    for (int i = 0; i < ST_SPIN_ITERS; i++) {
      if ((int64_t)(atomic_load_explicit(&g_pool.afin,
                                         memory_order_acquire) &
                    0xffffffffu) >= nseg) {
        waited = 1;
        break;
      }
      stc_cpu_relax();
    }
    if (!waited &&
        (int64_t)(atomic_load_explicit(&g_pool.afin, memory_order_acquire) &
                  0xffffffffu) < nseg) {
      atomic_store_explicit(&g_pool.sub_waiting, 1, memory_order_release);
      stc_mutex_lock(&g_pool.mu);
      while ((int64_t)(atomic_load_explicit(&g_pool.afin,
                                            memory_order_acquire) &
                       0xffffffffu) < nseg) {
        struct timespec ts;
        clock_gettime(CLOCK_REALTIME, &ts);
        ts.tv_nsec += 2000000; /* 2 ms tick: bounds the signal race */
        if (ts.tv_nsec >= 1000000000) {
          ts.tv_sec++;
          ts.tv_nsec -= 1000000000;
        }
        pthread_cond_timedwait(&g_pool.cv_done, &g_pool.mu.m, &ts);
      }
      stc_mutex_unlock(&g_pool.mu);
      atomic_store_explicit(&g_pool.sub_waiting, 0, memory_order_release);
    }
  }
  stc_mutex_unlock(&g_pool.job_mu);
  return 1;
}

/* A chunk is a word range [w0, w1) inside ONE leaf (never spans leaves —
 * each kernel body stays a single-leaf range loop). Fixed decomposition:
 * every leaf splits at ST_CHUNK_ELEMS boundaries of its own padded span. */
typedef struct {
  int64_t leaf, w0, w1;
} stc_chunk;

/* total padded elements + chunk count for a layout */
static int64_t stc_count_chunks(const int64_t *padded, int64_t n_leaves,
                                int64_t *out_total) {
  int64_t total = 0, nc = 0;
  for (int64_t i = 0; i < n_leaves; i++) {
    total += padded[i];
    nc += (padded[i] + ST_CHUNK_ELEMS - 1) / ST_CHUNK_ELEMS;
  }
  if (out_total) *out_total = total;
  return nc;
}

static void stc_build_chunks(const int64_t *padded, int64_t n_leaves,
                             stc_chunk *out) {
  int64_t k = 0;
  for (int64_t i = 0; i < n_leaves; i++) {
    int64_t nw = padded[i] / 32, cw = ST_CHUNK_ELEMS / 32;
    for (int64_t w0 = 0; w0 < nw; w0 += cw) {
      out[k].leaf = i;
      out[k].w0 = w0;
      out[k].w1 = w0 + cw < nw ? w0 + cw : nw;
      k++;
    }
    /* an empty leaf (padded == 0) contributes no chunks; partial outputs
     * for it are zero-filled by the wrappers */
  }
}
#else
#define ST_PAR_MIN_ELEMS ((int64_t)1 << 62)
#endif

/* Sender half for one leaf: sign-quantize + pack + error feedback, one fused
 * pass. bit = (r <= 0) — zero counts as negative (reference quirk Q3, kept:
 * converged elements oscillate within +/-scale). With s == 0 the leaf idles:
 * bits still record signs (matching the XLA/numpy tiers bit-for-bit) but the
 * residual is untouched. */
#ifdef ST_AVX512
/* Words whose 32 lanes are all live: two 16-lane compares produce the
 * bitmask directly; +/-s is the scale with the mask spliced into the IEEE
 * sign bit (exactly the scalar code's union trick, 16 lanes at a time).
 * Processes words [w0, min(w1, n/32)); returns the stopping word. */
ST_TARGET_AVX512
static int64_t quantize_leaf_avx512(const float *rin, float *rout, int64_t n,
                                    float s, uint32_t *words, int64_t w0,
                                    int64_t w1) {
  const __m512 vzero = _mm512_setzero_ps();
  const __m512i vs = _mm512_castps_si512(_mm512_set1_ps(s));
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  int64_t w = w0, wl = n / 32 < w1 ? n / 32 : w1;
  for (; w < wl; w++) {
    const float *p = rin + w * 32;
    float *q = rout + w * 32;
    __m512 v0 = _mm512_loadu_ps(p);
    __m512 v1 = _mm512_loadu_ps(p + 16);
    __mmask16 m0 = _mm512_cmp_ps_mask(v0, vzero, _CMP_LE_OQ);
    __mmask16 m1 = _mm512_cmp_ps_mask(v1, vzero, _CMP_LE_OQ);
    if (s > 0.0f) {
      __m512 d0 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m0, vs, vsign));
      __m512 d1 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m1, vs, vsign));
      _mm512_storeu_ps(q, _mm512_sub_ps(v0, d0));
      _mm512_storeu_ps(q + 16, _mm512_sub_ps(v1, d1));
    } else {
      _mm512_storeu_ps(q, v0);
      _mm512_storeu_ps(q + 16, v1);
    }
    words[w] = (uint32_t)m0 | ((uint32_t)m1 << 16);
  }
  return w;
}
#endif

/* words [w0, w1) of one leaf (w1 <= padded/32) */
ST_CLONES
static void quantize_leaf_range(const float *rin, float *rout, int64_t n,
                                float s, uint32_t *words, int64_t w0,
                                int64_t w1) {
  int64_t nw = w1;
  int64_t w = w0;
#ifdef ST_AVX512
  if (st_has_avx512())
    w = quantize_leaf_avx512(rin, rout, n, s, words, w0, w1);
#endif
  for (; w < nw; w++) {
    uint32_t bits = 0;
    int64_t base = w * 32;
    int64_t lim = n - base;
    if (lim > 32) lim = 32;
    if (s > 0.0f) {
      for (int64_t b = 0; b < lim; b++) {
        float v = rin[base + b];
        uint32_t neg = v <= 0.0f;
        bits |= neg << b;
        rout[base + b] = v - (neg ? -s : s);
      }
    } else {
      for (int64_t b = 0; b < lim; b++) {
        float v = rin[base + b];
        bits |= (uint32_t)(v <= 0.0f) << b;
        rout[base + b] = v;
      }
    }
    /* the caller hands a fresh output buffer: re-establish the all-zero
     * padding invariant on lanes past the live elements */
    for (int64_t b = (lim < 0 ? 0 : lim); b < 32; b++) rout[base + b] = 0.0f;
    words[w] = bits;
  }
}

#ifdef ST_AVX512
/* 16 floats/iter; squares/sums accumulate in 8-lane doubles, so the
 * result is a double-sum like the scalar path (order differs; double
 * accumulation makes the difference vanish below f32 rounding — the
 * tiers tolerate 1-ulp scale differences, see ops/codec_np.py).
 * Covers elements [j0, n) in 16-lane steps; returns the stopping element;
 * partials land in amax, ss, sabs. */
ST_TARGET_AVX512
static int64_t scale_partials_leaf_avx512(const float *p, int64_t n,
                                          double *amax, double *ss,
                                          double *sabs, int64_t j0) {
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t j = j0;
  for (; j + 16 <= n; j += 16) {
    __m512 v = _mm512_loadu_ps(p + j);
    __m512 a = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(v), vabsmask));
    vamax = _mm512_max_ps(vamax, a);
    __m512d lo = _mm512_cvtps_pd(_mm512_castps512_ps256(v));
    __m512d hi = _mm512_cvtps_pd(_mm512_extractf32x8_ps(v, 1));
    vss0 = _mm512_fmadd_pd(lo, lo, vss0);
    vss1 = _mm512_fmadd_pd(hi, hi, vss1);
    __m512d alo = _mm512_cvtps_pd(_mm512_castps512_ps256(a));
    __m512d ahi = _mm512_cvtps_pd(_mm512_extractf32x8_ps(a, 1));
    vsa0 = _mm512_add_pd(vsa0, alo);
    vsa1 = _mm512_add_pd(vsa1, ahi);
  }
  *amax = _mm512_reduce_max_ps(vamax);
  *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
  *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  return j;
}
#endif

/* Reduction partials of LIVE elements [e0, e1) of one leaf (e1 <= ns):
 * max|r|, sum(r^2), sum(|r|). Double accumulators make the raw sums
 * overflow-safe by construction (f32 max squared ~1.2e77 << DBL_MAX), where
 * the f32 tiers need the amax-normalization trick (quirk Q9 discussion in
 * ops/codec.compute_scale). The Python caller finishes the policy math. */
ST_CLONES
static void scale_partials_range(const float *p, int64_t e0, int64_t e1,
                                 double *out_amax, double *out_ss,
                                 double *out_sabs) {
  /* 4-way unrolled accumulators: breaks the serial FP dependency chain so
   * the adds pipeline (a single double accumulator costs ~4 cycles/elem) */
  double amax[4] = {0, 0, 0, 0}, ss[4] = {0, 0, 0, 0}, sabs[4] = {0, 0, 0, 0};
  int64_t j = e0;
#ifdef ST_AVX512
  if (st_has_avx512())
    j = scale_partials_leaf_avx512(p, e1, &amax[0], &ss[0], &sabs[0], e0);
#endif
  for (; j + 4 <= e1; j += 4) {
    for (int u = 0; u < 4; u++) {
      double v = p[j + u];
      double a = v < 0 ? -v : v;
      if (a > amax[u]) amax[u] = a;
      ss[u] += v * v;
      sabs[u] += a;
    }
  }
  for (; j < e1; j++) {
    double v = p[j];
    double a = v < 0 ? -v : v;
    if (a > amax[0]) amax[0] = a;
    ss[0] += v * v;
    sabs[0] += a;
  }
  double am = amax[0];
  for (int u = 1; u < 4; u++)
    if (amax[u] > am) am = amax[u];
  *out_amax = am;
  *out_ss = ss[0] + ss[1] + ss[2] + ss[3];
  *out_sabs = sabs[0] + sabs[1] + sabs[2] + sabs[3];
}

#ifdef ST_POOL
/* Per-leaf reduction of per-chunk partials, in chunk order: the grouping is
 * fixed by the layout (stc_build_chunks), so the result is identical for
 * every thread count. */
static void reduce_chunk_partials(const stc_chunk *chunks, int64_t nc,
                                  int64_t n_leaves, const double *camax,
                                  const double *css, const double *csabs,
                                  double *out_amax, double *out_ss,
                                  double *out_sabs) {
  for (int64_t i = 0; i < n_leaves; i++) {
    out_amax[i] = 0;
    out_ss[i] = 0;
    out_sabs[i] = 0;
  }
  for (int64_t c = 0; c < nc; c++) {
    int64_t i = chunks[c].leaf;
    if (camax[c] > out_amax[i]) out_amax[i] = camax[c];
    out_ss[i] += css[c];
    out_sabs[i] += csabs[c];
  }
}

typedef struct {
  const float *r;
  const int64_t *off, *ns;
  const stc_chunk *chunks;
  double *camax, *css, *csabs;
} sp_ctx;

static void scale_partials_seg(void *vctx, int64_t c) {
  sp_ctx *x = (sp_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t n = x->ns[ch->leaf];
  int64_t e0 = ch->w0 * 32, e1 = ch->w1 * 32;
  if (e1 > n) e1 = n;
  if (e0 > e1) e0 = e1;
  scale_partials_range(x->r + x->off[ch->leaf], e0, e1, &x->camax[c],
                       &x->css[c], &x->csabs[c]);
}
#endif

EXPORT void stc_scale_partials(const float *r, const int64_t *off,
                               const int64_t *ns, int64_t n_leaves,
                               double *out_amax, double *out_ss,
                               double *out_sabs) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = 0;
  /* chunk over round32(ns) word spans — identical decomposition to the
   * other ops when padded == round32(ns), which the table layout
   * guarantees, so fused and standalone partials group alike */
  for (int64_t i = 0; i < n_leaves; i++) total += ns[i];
  if (total >= ST_PAR_MIN_ELEMS) {
    /* build chunks over round32(ns) per leaf */
    int64_t cap = 0;
    for (int64_t i = 0; i < n_leaves; i++)
      cap += ((ns[i] + 31) / 32 * 32 + ST_CHUNK_ELEMS - 1) / ST_CHUNK_ELEMS;
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)cap * sizeof(stc_chunk));
    double *pbuf = (double *)malloc((size_t)cap * 3 * sizeof(double));
    if (chunks && pbuf) {
      int64_t k = 0;
      for (int64_t i = 0; i < n_leaves; i++) {
        int64_t nw = (ns[i] + 31) / 32, cw = ST_CHUNK_ELEMS / 32;
        for (int64_t w0 = 0; w0 < nw; w0 += cw) {
          chunks[k].leaf = i;
          chunks[k].w0 = w0;
          chunks[k].w1 = w0 + cw < nw ? w0 + cw : nw;
          k++;
        }
      }
      nc = k;
      sp_ctx x = {r, off, ns, chunks, pbuf, pbuf + nc, pbuf + 2 * nc};
      if (stc_pool_run(scale_partials_seg, &x, nc)) {
        reduce_chunk_partials(chunks, nc, n_leaves, x.camax, x.css, x.csabs,
                              out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++)
    scale_partials_range(r + off[i], 0, ns[i], &out_amax[i], &out_ss[i],
                         &out_sabs[i]);
}

#ifdef ST_POOL
typedef struct {
  const float *rin;
  float *rout;
  const int64_t *off, *ns;
  const float *scales;
  uint32_t *words;
  const stc_chunk *chunks;
} qz_ctx;

static void quantize_seg(void *vctx, int64_t c) {
  qz_ctx *x = (qz_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  quantize_leaf_range(x->rin + x->off[i], x->rout + x->off[i], x->ns[i],
                      x->scales[i], x->words + x->off[i] / 32, ch->w0, ch->w1);
}
#endif

/* Functional form — reads rin, writes rout (the Python tier's update
 * discipline is replace-not-mutate, so writing to a fresh output buffer
 * saves the 4-byte-per-element input copy an in-place API would force). */
EXPORT void stc_quantize(const float *rin, float *rout, const int64_t *off,
                         const int64_t *ns, const int64_t *padded,
                         int64_t n_leaves, const float *scales,
                         uint32_t *words) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    if (chunks) {
      stc_build_chunks(padded, n_leaves, chunks);
      qz_ctx x = {rin, rout, off, ns, scales, words, chunks};
      int ran = stc_pool_run(quantize_seg, &x, nc);
      free(chunks);
      if (ran) return;
    }
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    quantize_leaf_range(rin + off[i], rout + off[i], ns[i], scales[i],
                        words + off[i] / 32, 0, padded[i] / 32);
  }
}

#ifdef ST_AVX512
/* The packed word IS two __mmask16s: splice each bit into the IEEE sign
 * of a broadcast s (bit set -> -s, reference src/sharedtensor.c:109)
 * and accumulate, 16 lanes per op. Covers whole words [w0, full);
 * returns the stopping word. */
ST_TARGET_AVX512
static int64_t accumulate_leaf_avx512(float *d, const uint32_t *w,
                                      int64_t full, float s, int64_t w0) {
  const __m512i vs = _mm512_castps_si512(_mm512_set1_ps(s));
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  int64_t k = w0;
  for (; k < full; k++) {
    uint32_t bits = w[k];
    float *dd = d + k * 32;
    __mmask16 m0 = (__mmask16)bits;
    __mmask16 m1 = (__mmask16)(bits >> 16);
    __m512 d0 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m0, vs, vsign));
    __m512 d1 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m1, vs, vsign));
    _mm512_storeu_ps(dd, _mm512_add_ps(_mm512_loadu_ps(dd), d0));
    _mm512_storeu_ps(dd + 16, _mm512_add_ps(_mm512_loadu_ps(dd + 16), d1));
  }
  return k;
}
#endif

#ifdef ST_AVX512
/* Fused quantize + next-frame partials: the burst sender needs the NEW
 * residual's scale partials for frame k+1, and they are free to accumulate
 * while frame k's residual values are still in registers — one memory pass
 * instead of quantize-then-rescan (the two-pass shape costs ~40% of the
 * engine's per-frame time at 1 Mi). Covers words [w0, min(w1, n/32));
 * returns the stopping word. */
ST_TARGET_AVX512
static int64_t quantize_partials_leaf_avx512(const float *rin, float *rout,
                                             int64_t n, float s,
                                             uint32_t *words, double *amax,
                                             double *ss, double *sabs,
                                             int64_t w0, int64_t w1) {
  const __m512 vzero = _mm512_setzero_ps();
  const __m512i vs = _mm512_castps_si512(_mm512_set1_ps(s));
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t w = w0, wl = n / 32 < w1 ? n / 32 : w1;
  for (; w < wl; w++) {
    const float *p = rin + w * 32;
    float *q = rout + w * 32;
    __m512 v0 = _mm512_loadu_ps(p);
    __m512 v1 = _mm512_loadu_ps(p + 16);
    __mmask16 m0 = _mm512_cmp_ps_mask(v0, vzero, _CMP_LE_OQ);
    __mmask16 m1 = _mm512_cmp_ps_mask(v1, vzero, _CMP_LE_OQ);
    __m512 r0 = v0, r1 = v1;
    if (s > 0.0f) {
      __m512 d0 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m0, vs, vsign));
      __m512 d1 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m1, vs, vsign));
      r0 = _mm512_sub_ps(v0, d0);
      r1 = _mm512_sub_ps(v1, d1);
    }
    _mm512_storeu_ps(q, r0);
    _mm512_storeu_ps(q + 16, r1);
    words[w] = (uint32_t)m0 | ((uint32_t)m1 << 16);
    /* partials of the residual just written (scale_partials_leaf_avx512's
     * arithmetic, fused here) */
    __m512 a0 = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(r0), vabsmask));
    __m512 a1 = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(r1), vabsmask));
    vamax = _mm512_max_ps(vamax, _mm512_max_ps(a0, a1));
    __m512d lo0 = _mm512_cvtps_pd(_mm512_castps512_ps256(r0));
    __m512d hi0 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(r0, 1));
    __m512d lo1 = _mm512_cvtps_pd(_mm512_castps512_ps256(r1));
    __m512d hi1 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(r1, 1));
    vss0 = _mm512_fmadd_pd(lo0, lo0, vss0);
    vss1 = _mm512_fmadd_pd(hi0, hi0, vss1);
    vss0 = _mm512_fmadd_pd(lo1, lo1, vss0);
    vss1 = _mm512_fmadd_pd(hi1, hi1, vss1);
    vsa0 = _mm512_add_pd(
        vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a0)));
    vsa1 = _mm512_add_pd(
        vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a0, 1)));
    vsa0 = _mm512_add_pd(
        vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a1)));
    vsa1 = _mm512_add_pd(
        vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a1, 1)));
  }
  *amax = _mm512_reduce_max_ps(vamax);
  *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
  *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  return w;
}
#endif

/* Quantize + new-residual partials for words [w0, w1) of one leaf (the
 * fused body of stc_quantize_ef_partials). */
ST_CLONES
static void quantize_partials_range(const float *p, float *q, int64_t n,
                                    float s, uint32_t *wp, int64_t w0,
                                    int64_t w1, double *out_amax,
                                    double *out_ss, double *out_sabs) {
  double amax = 0, ssum = 0, sabs = 0;
  int64_t w = w0;
#ifdef ST_AVX512
  if (st_has_avx512())
    w = quantize_partials_leaf_avx512(p, q, n, s, wp, &amax, &ssum, &sabs, w0,
                                      w1);
#endif
  for (; w < w1; w++) {
    uint32_t bits = 0;
    int64_t base = w * 32;
    int64_t lim = n - base;
    if (lim > 32) lim = 32;
    for (int64_t b = 0; b < (lim < 0 ? 0 : lim); b++) {
      float v = p[base + b];
      uint32_t neg = v <= 0.0f;
      bits |= neg << b;
      float r = s > 0.0f ? v - (neg ? -s : s) : v;
      q[base + b] = r;
      double a = r < 0 ? -(double)r : (double)r;
      if (a > amax) amax = a;
      ssum += (double)r * (double)r;
      sabs += a;
    }
    for (int64_t b = (lim < 0 ? 0 : lim); b < 32; b++) q[base + b] = 0.0f;
    wp[w] = bits;
  }
  *out_amax = amax;
  *out_ss = ssum;
  *out_sabs = sabs;
}

#ifdef ST_POOL
typedef struct {
  const float *rin;
  float *rout;
  const int64_t *off, *ns;
  const float *scales;
  uint32_t *words;
  const stc_chunk *chunks;
  double *camax, *css, *csabs;
} qzp_ctx;

static void quantize_partials_seg(void *vctx, int64_t c) {
  qzp_ctx *x = (qzp_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  quantize_partials_range(x->rin + x->off[i], x->rout + x->off[i], x->ns[i],
                          x->scales[i], x->words + x->off[i] / 32, ch->w0,
                          ch->w1, &x->camax[c], &x->css[c], &x->csabs[c]);
}
#endif

/* Sender step + NEXT frame's scale partials, one fused pass per leaf (see
 * quantize_partials_leaf_avx512). Partials are per-leaf overwrites like
 * stc_scale_partials; live lanes only. Semantics of the quantize half are
 * identical to stc_quantize. */
EXPORT void stc_quantize_ef_partials(
    const float *rin, float *rout, const int64_t *off, const int64_t *ns,
    const int64_t *padded, int64_t n_leaves, const float *scales,
    uint32_t *words, double *out_amax, double *out_ss, double *out_sabs) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    double *pbuf = (double *)malloc((size_t)nc * 3 * sizeof(double));
    if (chunks && pbuf) {
      stc_build_chunks(padded, n_leaves, chunks);
      qzp_ctx x = {rin,    rout,  off,  ns,         scales,
                   words,  chunks, pbuf, pbuf + nc, pbuf + 2 * nc};
      if (stc_pool_run(quantize_partials_seg, &x, nc)) {
        reduce_chunk_partials(chunks, nc, n_leaves, x.camax, x.css, x.csabs,
                              out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    quantize_partials_range(rin + off[i], rout + off[i], ns[i], scales[i],
                            words + off[i] / 32, 0, padded[i] / 32,
                            &out_amax[i], &out_ss[i], &out_sabs[i]);
  }
}

/* delta += s*(1-2*bit) over words [w0, w1) of one leaf; the partial word
 * (if any) is handled when it falls inside the range. */
ST_CLONES
static void accumulate_delta_range(float *d, const uint32_t *w, int64_t n,
                                   float s, int64_t w0, int64_t w1) {
  int64_t full = n / 32; /* whole words: branch-free, vectorizable */
  if (full > w1) full = w1;
  int64_t k = w0;
#ifdef ST_AVX512
  if (st_has_avx512()) k = accumulate_leaf_avx512(d, w, full, s, w0);
#endif
  for (; k < full; k++) {
    uint32_t bits = w[k];
    float *dd = d + k * 32;
    float signs[32];
    /* +/-s differ only in the IEEE sign bit: splice the codec bit in */
    for (int b = 0; b < 32; b++) {
      union { float f; uint32_t u; } u;
      u.f = s;
      u.u |= ((bits >> b) & 1u) << 31;
      signs[b] = u.f;
    }
    for (int b = 0; b < 32; b++) dd[b] += signs[b];
  }
  if (n % 32 && n / 32 >= w0 && n / 32 < w1) {
    int64_t base = (n / 32) * 32;
    uint32_t bits = w[n / 32];
    for (int64_t b = 0; b < n - base; b++) {
      d[base + b] += ((bits >> b) & 1u) ? -s : s;
    }
  }
}

#ifdef ST_POOL
typedef struct {
  float *delta;
  const int64_t *off, *ns;
  const float *scales;
  const uint32_t *words;
  const stc_chunk *chunks;
} ad_ctx;

static void accumulate_delta_seg(void *vctx, int64_t c) {
  ad_ctx *x = (ad_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  float s = x->scales[i];
  if (s == 0.0f) return;
  accumulate_delta_range(x->delta + x->off[i], x->words + x->off[i] / 32,
                         x->ns[i], s, ch->w0, ch->w1);
}
#endif

/* Receiver half: accumulate K frames' deltas into delta[total]
 * (delta += s * (1 - 2*bit), reference src/sharedtensor.c:109), then the
 * caller adds delta to each target array. Splitting accumulate/apply keeps
 * the per-array work to one add pass regardless of K. */
EXPORT void stc_accumulate_delta(float *delta, const int64_t *off,
                                 const int64_t *ns, const int64_t *padded,
                                 int64_t n_leaves, const float *scales,
                                 const uint32_t *words) {
#ifdef ST_POOL
  if (padded) {
    int64_t total = 0;
    int64_t nc = stc_count_chunks(padded, n_leaves, &total);
    if (total >= ST_PAR_MIN_ELEMS) {
      stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
      if (chunks) {
        stc_build_chunks(padded, n_leaves, chunks);
        ad_ctx x = {delta, off, ns, scales, words, chunks};
        int ran = stc_pool_run(accumulate_delta_seg, &x, nc);
        free(chunks);
        if (ran) return;
      }
    }
  }
#endif
  (void)padded;
  for (int64_t i = 0; i < n_leaves; i++) {
    float s = scales[i];
    if (s == 0.0f) continue;
    accumulate_delta_range(delta + off[i], words + off[i] / 32, ns[i], s, 0,
                           ns[i] / 32 + (ns[i] % 32 ? 1 : 0));
  }
}

ST_CLONES
static void add_to_range(float *out, const float *a, const float *delta,
                         int64_t i0, int64_t i1) {
  for (int64_t i = i0; i < i1; i++) {
    float s = a[i] + delta[i];
    s = s > 3.0e38f ? 3.0e38f : s;
    s = s < -3.0e38f ? -3.0e38f : s;
    out[i] = s;
  }
}

#ifdef ST_POOL
/* flat elementwise split: fixed ST_CHUNK_ELEMS ranges over [0, total) */
typedef struct {
  float *out;
  const float *a, *b;
  int64_t total;
  int op; /* 0 = add_to, 1 = accumulate_update */
} ew_ctx;

static void elementwise_seg(void *vctx, int64_t c);

static int elementwise_par(int op, float *out, const float *a, const float *b,
                           int64_t total) {
  if (total < ST_PAR_MIN_ELEMS) return 0;
  ew_ctx x = {out, a, b, total, op};
  int64_t nseg = (total + ST_CHUNK_ELEMS - 1) / ST_CHUNK_ELEMS;
  return stc_pool_run(elementwise_seg, &x, nseg);
}
#endif

/* values[i] += delta[i] for one target array (live lanes only — padding in
 * both is 0 by invariant, so a full-width add preserves it). Result clamped
 * to +/-3e38 like every other state-mutating path (ops/codec.SAT: no
 * absorbing inf/NaN state, any tier). Branchless min/max — vectorizes. */
EXPORT void stc_add_inplace(float *values, const float *delta, int64_t total) {
#ifdef ST_POOL
  if (elementwise_par(0, values, values, delta, total)) return;
#endif
  add_to_range(values, values, delta, 0, total);
}

/* out[i] = clip(a[i] + delta[i]): the functional-update form of
 * stc_add_inplace. One pass instead of copy-then-add — at table sizes past
 * LLC the host tier is memory-bandwidth-bound and the extra copy pass was
 * ~1/3 of the apply cost (measured at 16 Mi elements). */
EXPORT void stc_add_to(float *out, const float *a, const float *delta,
                       int64_t total) {
#ifdef ST_POOL
  if (elementwise_par(0, out, a, delta, total)) return;
#endif
  add_to_range(out, a, delta, 0, total);
}

#ifdef ST_AVX512
ST_TARGET_AVX512
static int64_t apply_leaf_avx512(const float *in, float *out,
                                 const uint32_t *w, int64_t full, float s,
                                 int64_t w0) {
  const __m512i vs = _mm512_castps_si512(_mm512_set1_ps(s));
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  const __m512 vmax = _mm512_set1_ps(3.0e38f);
  const __m512 vmin = _mm512_set1_ps(-3.0e38f);
  int64_t k = w0;
  for (; k < full; k++) {
    uint32_t bits = w[k];
    const float *pp = in + k * 32;
    float *qq = out + k * 32;
    __mmask16 m0 = (__mmask16)bits;
    __mmask16 m1 = (__mmask16)(bits >> 16);
    __m512 d0 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m0, vs, vsign));
    __m512 d1 = _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m1, vs, vsign));
    __m512 r0 = _mm512_add_ps(_mm512_loadu_ps(pp), d0);
    __m512 r1 = _mm512_add_ps(_mm512_loadu_ps(pp + 16), d1);
    r0 = _mm512_max_ps(_mm512_min_ps(r0, vmax), vmin);
    r1 = _mm512_max_ps(_mm512_min_ps(r1, vmax), vmin);
    _mm512_storeu_ps(qq, r0);
    _mm512_storeu_ps(qq + 16, r1);
  }
  return k;
}
#endif

/* out = clip(in + s*(1-2*bit)) over words [w0, w1) of one leaf; padding
 * lanes inside the range are copied verbatim (0 by invariant). */
ST_CLONES
static void apply_frame_range(const float *in, float *out, const uint32_t *w,
                              int64_t n, int64_t pad, float s, int64_t w0,
                              int64_t w1) {
  if (s == 0.0f) { /* idle leaf: pure copy */
    memcpy(out + w0 * 32, in + w0 * 32, (size_t)(w1 - w0) * 32 * sizeof(float));
    return;
  }
  int64_t full = n / 32;
  if (full > w1) full = w1;
  int64_t k = w0;
#ifdef ST_AVX512
  if (st_has_avx512()) k = apply_leaf_avx512(in, out, w, full, s, w0);
#endif
  for (; k < full; k++) {
    uint32_t bits = w[k];
    for (int b = 0; b < 32; b++) {
      float v = in[k * 32 + b] + (((bits >> b) & 1u) ? -s : s);
      v = v > 3.0e38f ? 3.0e38f : v;
      v = v < -3.0e38f ? -3.0e38f : v;
      out[k * 32 + b] = v;
    }
  }
  int64_t base = full * 32;
  if (n % 32 && n / 32 >= w0 && n / 32 < w1) {
    base = (n / 32) * 32;
    uint32_t bits = w[n / 32];
    for (int64_t b = 0; b < n - base; b++) {
      float v = in[base + b] + (((bits >> b) & 1u) ? -s : s);
      v = v > 3.0e38f ? 3.0e38f : v;
      v = v < -3.0e38f ? -3.0e38f : v;
      out[base + b] = v;
    }
    for (int64_t b = n - base; b < 32 && base + b < pad; b++)
      out[base + b] = in[base + b];
    base += 32;
  }
  /* trailing pure-padding words of THIS range only (a chunk past the live
   * data must not copy below its own w0 — that is another chunk's region) */
  if (base < w0 * 32) base = w0 * 32;
  int64_t end = w1 * 32;
  if (base < end && base < pad) {
    int64_t stop = end < pad ? end : pad;
    if (stop > base)
      memcpy(out + base, in + base, (size_t)(stop - base) * sizeof(float));
  }
}

#ifdef ST_POOL
typedef struct {
  const float *vin;
  float *vout;
  const int64_t *off, *ns, *padded;
  const float *scales;
  const uint32_t *words;
  const stc_chunk *chunks;
} ap_ctx;

static void apply_frame_seg(void *vctx, int64_t c) {
  ap_ctx *x = (ap_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  apply_frame_range(x->vin + x->off[i], x->vout + x->off[i],
                    x->words + x->off[i] / 32, x->ns[i], x->padded[i],
                    x->scales[i], ch->w0, ch->w1);
}
#endif

/* Fully fused single-frame apply: out = clip(in + s*(1-2*bit)) in ONE pass,
 * no delta buffer, no copy — the K=1 receive path (the common case: one
 * incoming frame applied to values + each other link's residual). Padding
 * lanes beyond ns[i] are copied verbatim (0 by invariant). */
EXPORT void stc_apply_frame(const float *vin, float *vout, const int64_t *off,
                            const int64_t *ns, const int64_t *padded,
                            int64_t n_leaves, const float *scales,
                            const uint32_t *words) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    if (chunks) {
      stc_build_chunks(padded, n_leaves, chunks);
      ap_ctx x = {vin, vout, off, ns, padded, scales, words, chunks};
      int ran = stc_pool_run(apply_frame_seg, &x, nc);
      free(chunks);
      if (ran) return;
    }
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    apply_frame_range(vin + off[i], vout + off[i], words + off[i] / 32, ns[i],
                      padded[i], scales[i], 0, padded[i] / 32);
  }
}

ST_CLONES
static void accumulate_update_range(float *a, const float *u, int64_t i0,
                                    int64_t i1) {
  for (int64_t i = i0; i < i1; i++) {
    float x = u[i];
    if (x != x) x = 0.0f; /* NaN */
    if (x > 3.0e38f) x = 3.0e38f;
    if (x < -3.0e38f) x = -3.0e38f;
    float s = a[i] + x;
    if (s > 3.0e38f) s = 3.0e38f;
    if (s < -3.0e38f) s = -3.0e38f;
    a[i] = s;
  }
}

#ifdef ST_POOL
static void elementwise_seg(void *vctx, int64_t c) {
  ew_ctx *x = (ew_ctx *)vctx;
  int64_t i0 = c * ST_CHUNK_ELEMS;
  int64_t i1 = i0 + ST_CHUNK_ELEMS;
  if (i1 > x->total) i1 = x->total;
  if (x->op == 0)
    add_to_range(x->out, x->a, x->b, i0, i1);
  else
    accumulate_update_range(x->out, x->b, i0, i1);
}
#endif

/* Local additive update, sanitized (quirk Q9 fix — one NaN in the reference
 * poisons every replica through the flood): u is pre-masked by the caller;
 * NaN -> 0, +/-inf and sums clamped to +/-3e38. */
EXPORT void stc_accumulate_update(float *a, const float *u, int64_t total) {
#ifdef ST_POOL
  if (elementwise_par(1, a, a, u, total)) return;
#endif
  accumulate_update_range(a, u, 0, total);
}

#ifdef ST_AVX512
/* clip(a + sanitize(u)) + result partials, 16 lanes at a time over
 * elements [j0, j0+16k) (k maximal with j0+16k <= n). The scalar loop's
 * NaN/clamp/partials mix defeats autovectorization (measured 1.2 GB/s vs
 * 12.5 for the partial-less op at 16 Mi — a 10x cliff on the add path);
 * this kernel restores it. Returns the stopping element. */
ST_TARGET_AVX512
static int64_t accumulate_update_leaf_avx512(float *op, const float *ap,
                                             const float *up, int64_t n,
                                             int64_t j0, int do_part,
                                             double *amax, double *ss,
                                             double *sabs) {
  const __m512 vmax = _mm512_set1_ps(3.0e38f);
  const __m512 vmin = _mm512_set1_ps(-3.0e38f);
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t j = j0;
  for (; j + 16 <= n; j += 16) {
    __m512 u = _mm512_loadu_ps(up + j);
    __mmask16 ord = _mm512_cmp_ps_mask(u, u, _CMP_ORD_Q);
    u = _mm512_maskz_mov_ps(ord, u); /* NaN -> 0 */
    u = _mm512_max_ps(_mm512_min_ps(u, vmax), vmin);
    __m512 s = _mm512_add_ps(_mm512_loadu_ps(ap + j), u);
    s = _mm512_max_ps(_mm512_min_ps(s, vmax), vmin);
    _mm512_storeu_ps(op + j, s);
    if (do_part) {
      __m512 a = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(s), vabsmask));
      vamax = _mm512_max_ps(vamax, a);
      __m512d lo = _mm512_cvtps_pd(_mm512_castps512_ps256(s));
      __m512d hi = _mm512_cvtps_pd(_mm512_extractf32x8_ps(s, 1));
      vss0 = _mm512_fmadd_pd(lo, lo, vss0);
      vss1 = _mm512_fmadd_pd(hi, hi, vss1);
      vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a)));
      vsa1 = _mm512_add_pd(vsa1,
                           _mm512_cvtps_pd(_mm512_extractf32x8_ps(a, 1)));
    }
  }
  if (do_part) {
    *amax = _mm512_reduce_max_ps(vamax);
    *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
    *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  }
  return j;
}
#endif

/* out = clip(a + sanitize(u)) on live lanes of elements [e0, e1) of one
 * leaf (e0/e1 in padded coordinates); padding lanes in range copy from a.
 * Optional partials of the RESULT (live lanes in range) — fusing them here
 * makes a sender-side scale scan free whenever an add() already has to
 * traverse the residual (stengine.cpp partials cache). */
ST_CLONES
static void accumulate_update_to_range(float *op, const float *ap,
                                       const float *up, int64_t n, int64_t pad,
                                       int64_t e0, int64_t e1, double *out_amax,
                                       double *out_ss, double *out_sabs) {
  double amax = 0, ssum = 0, sabs = 0;
  int64_t live = n < e1 ? n : e1;
  int64_t j = e0;
#ifdef ST_AVX512
  if (st_has_avx512() && j < live) {
    double a2 = 0, s2 = 0, b2 = 0;
    j = accumulate_update_leaf_avx512(op, ap, up, live, j,
                                      out_amax != NULL, &a2, &s2, &b2);
    if (out_amax) {
      amax = a2;
      ssum = s2;
      sabs = b2;
    }
  }
#endif
  for (; j < live; j++) {
    float x = up[j];
    if (x != x) x = 0.0f; /* NaN */
    if (x > 3.0e38f) x = 3.0e38f;
    if (x < -3.0e38f) x = -3.0e38f;
    float s = ap[j] + x;
    if (s > 3.0e38f) s = 3.0e38f;
    if (s < -3.0e38f) s = -3.0e38f;
    op[j] = s;
    if (out_amax) {
      double d = s < 0 ? -(double)s : (double)s;
      if (d > amax) amax = d;
      ssum += (double)s * (double)s;
      sabs += d;
    }
  }
  int64_t cs = n > e0 ? n : e0;
  if (cs < e1 && cs < pad) {
    int64_t stop = e1 < pad ? e1 : pad;
    if (stop > cs)
      memcpy(op + cs, ap + cs, (size_t)(stop - cs) * sizeof(float));
  }
  if (out_amax) {
    *out_amax = amax;
    *out_ss = ssum;
    *out_sabs = sabs;
  }
}

#ifdef ST_POOL
typedef struct {
  float *vout;
  const float *a, *u;
  const int64_t *off, *ns, *padded;
  const stc_chunk *chunks;
  double *camax, *css, *csabs; /* NULL when no partials requested */
} au_ctx;

static void accumulate_update_to_seg(void *vctx, int64_t c) {
  au_ctx *x = (au_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  accumulate_update_to_range(
      x->vout + x->off[i], x->a + x->off[i], x->u + x->off[i], x->ns[i],
      x->padded[i], ch->w0 * 32, ch->w1 * 32,
      x->camax ? &x->camax[c] : NULL, x->camax ? &x->css[c] : NULL,
      x->camax ? &x->csabs[c] : NULL);
}
#endif

static void accumulate_update_to_impl(float *vout, const float *a,
                                      const float *u, const int64_t *off,
                                      const int64_t *ns, const int64_t *padded,
                                      int64_t n_leaves, double *out_amax,
                                      double *out_ss, double *out_sabs) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    double *pbuf =
        out_amax ? (double *)malloc((size_t)nc * 3 * sizeof(double)) : NULL;
    if (chunks && (!out_amax || pbuf)) {
      stc_build_chunks(padded, n_leaves, chunks);
      au_ctx x = {vout,   a,
                  u,      off,
                  ns,     padded,
                  chunks, pbuf,
                  pbuf ? pbuf + nc : NULL, pbuf ? pbuf + 2 * nc : NULL};
      if (stc_pool_run(accumulate_update_to_seg, &x, nc)) {
        if (out_amax)
          reduce_chunk_partials(chunks, nc, n_leaves, x.camax, x.css, x.csabs,
                                out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    accumulate_update_to_range(vout + off[i], a + off[i], u + off[i], ns[i],
                               padded[i], 0, padded[i],
                               out_amax ? &out_amax[i] : NULL,
                               out_amax ? &out_ss[i] : NULL,
                               out_amax ? &out_sabs[i] : NULL);
  }
}

/* Functional one-pass form: out = clip(a + sanitize(u)) on live lanes,
 * out = a on padding (so a raw update's padding garbage never enters the
 * buffer — the caller no longer pre-masks or copies). Replaces the
 * copy-then-inplace pattern, which cost an extra full memory pass per
 * target array (the add path runs once per link residual plus the replica). */
EXPORT void stc_accumulate_update_to(float *vout, const float *a,
                                     const float *u, const int64_t *off,
                                     const int64_t *ns, const int64_t *padded,
                                     int64_t n_leaves) {
  accumulate_update_to_impl(vout, a, u, off, ns, padded, n_leaves, NULL, NULL,
                            NULL);
}

/* stc_accumulate_update_to + scale partials of the result in the same pass
 * (the stengine.cpp per-link partials cache: an add() that already walks a
 * residual refreshes its scale partials for free, killing the sender's
 * standalone stc_scale_partials scan — at 16 Mi that scan was a full 64 MiB
 * read per frame, 1/3 of the sender's memory traffic). */
EXPORT void stc_accumulate_update_to_partials(
    float *vout, const float *a, const float *u, const int64_t *off,
    const int64_t *ns, const int64_t *padded, int64_t n_leaves,
    double *out_amax, double *out_ss, double *out_sabs) {
  accumulate_update_to_impl(vout, a, u, off, ns, padded, n_leaves, out_amax,
                            out_ss, out_sabs);
}

/* ---- k-frame fused apply --------------------------------------------------
 *
 * out = clip(in + sum_f s_f*(1-2*bit_f)) in ONE pass over the target.
 * The batched receive path previously accumulated k frames into a delta
 * buffer (k read-modify-write passes over total*4 bytes) and then added the
 * delta to each target — at 16 Mi that is k*128 MiB of traffic before any
 * target is touched. This kernel reads each frame's PACKED words instead
 * (k * total/8 bytes — 16x smaller) and visits the target once:
 * per batch per target, 128 MiB + k*8 MiB instead of k*128 + 192 MiB.
 *
 * Bit-exact equivalence with both existing paths by construction:
 *   - the +/-s_f sum accumulates from 0 in frame order, exactly the order
 *     stc_accumulate_delta applied them to the delta buffer, and the final
 *     add+clip matches stc_add_to's clip(a + delta);
 *   - k == 1 reduces to clip(in +/- s), stc_apply_frame's arithmetic.
 * Leaves where every frame's scale is zero are copied verbatim (the k == 1
 * path's idle-leaf memcpy).
 *
 * EXCEPTION — the malloc-failure fallback below is NOT bit-identical for
 * k > 1: when the active-frame table cannot be allocated it applies frames
 * one at a time via stc_apply_frame, which clamps after EVERY frame and
 * rounds (in+d1)+d2 instead of in+(d1+...+dk) — up to ~1 ulp per element
 * off the fused path (more if intermediate sums hit the +/-3e38 clamp).
 * Rerouting through the provably-identical accumulate_delta+add_to
 * pipeline is not possible there: it needs a total*4-byte delta buffer,
 * and this branch exists precisely because allocation just failed. The
 * divergence only occurs under OOM and stays inside the ~1-ulp tier
 * tolerance every consumer of these arrays already accepts
 * (ADVICE r05 finding 4).
 *
 * Optional out_amax/out_ss/out_sabs (NULL ok): scale partials of the result,
 * fused like stc_quantize_ef_partials — for residual targets whose next
 * quantize needs them (stengine.cpp partials cache). */

#ifdef ST_AVX512
/* whole live words [w0, wl): m active (nonzero-scale) frames, per-frame
 * splatted scale vectors prebuilt by the caller. */
ST_TARGET_AVX512
static int64_t apply_frames_avx512(const float *in, float *out,
                                   const uint32_t *const *wps,
                                   const float *svals, int m, int64_t wl,
                                   int64_t w0, int do_part, double *amax,
                                   double *ss, double *sabs) {
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  const __m512 vmax = _mm512_set1_ps(3.0e38f);
  const __m512 vmin = _mm512_set1_ps(-3.0e38f);
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t w = w0;
  for (; w < wl; w++) {
    __m512 acc0 = _mm512_setzero_ps();
    __m512 acc1 = _mm512_setzero_ps();
    for (int f = 0; f < m; f++) {
      uint32_t bits = wps[f][w];
      const __m512i vs = _mm512_castps_si512(_mm512_set1_ps(svals[f]));
      __mmask16 m0 = (__mmask16)bits;
      __mmask16 m1 = (__mmask16)(bits >> 16);
      acc0 = _mm512_add_ps(
          acc0, _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m0, vs, vsign)));
      acc1 = _mm512_add_ps(
          acc1, _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m1, vs, vsign)));
    }
    const float *pp = in + w * 32;
    float *qq = out + w * 32;
    __m512 r0 = _mm512_add_ps(_mm512_loadu_ps(pp), acc0);
    __m512 r1 = _mm512_add_ps(_mm512_loadu_ps(pp + 16), acc1);
    r0 = _mm512_max_ps(_mm512_min_ps(r0, vmax), vmin);
    r1 = _mm512_max_ps(_mm512_min_ps(r1, vmax), vmin);
    _mm512_storeu_ps(qq, r0);
    _mm512_storeu_ps(qq + 16, r1);
    if (do_part) {
      __m512 a0 = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(r0), vabsmask));
      __m512 a1 = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(r1), vabsmask));
      vamax = _mm512_max_ps(vamax, _mm512_max_ps(a0, a1));
      __m512d lo0 = _mm512_cvtps_pd(_mm512_castps512_ps256(r0));
      __m512d hi0 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(r0, 1));
      __m512d lo1 = _mm512_cvtps_pd(_mm512_castps512_ps256(r1));
      __m512d hi1 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(r1, 1));
      vss0 = _mm512_fmadd_pd(lo0, lo0, vss0);
      vss1 = _mm512_fmadd_pd(hi0, hi0, vss1);
      vss0 = _mm512_fmadd_pd(lo1, lo1, vss0);
      vss1 = _mm512_fmadd_pd(hi1, hi1, vss1);
      vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a0)));
      vsa1 =
          _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a0, 1)));
      vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a1)));
      vsa1 =
          _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a1, 1)));
    }
  }
  if (do_part) {
    *amax = _mm512_reduce_max_ps(vamax);
    *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
    *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  }
  return w;
}
#endif

/* One leaf's words [w0, w1): m active frames with word pointers wps[] and
 * scales svals[]. Partials (when requested) cover live lanes in range. */
ST_CLONES
static void apply_frames_range(const float *in, float *out,
                               const uint32_t *const *wps, const float *svals,
                               int m, int64_t n, int64_t pad, int64_t w0,
                               int64_t w1, double *out_amax, double *out_ss,
                               double *out_sabs) {
  double amax = 0, ssum = 0, sabs = 0;
  int64_t full = n / 32;
  if (full > w1) full = w1;
  int64_t k = w0;
  int do_part = out_amax != NULL;
#ifdef ST_AVX512
  if (st_has_avx512() && k < full) {
    double a2 = 0, s2 = 0, b2 = 0;
    k = apply_frames_avx512(in, out, wps, svals, m, full, w0, do_part, &a2,
                            &s2, &b2);
    if (do_part) {
      amax = a2;
      ssum = s2;
      sabs = b2;
    }
  }
#endif
  for (; k < full; k++) {
    for (int b = 0; b < 32; b++) {
      float acc = 0.0f;
      for (int f = 0; f < m; f++) {
        float s = svals[f];
        acc += ((wps[f][k] >> b) & 1u) ? -s : s;
      }
      float v = in[k * 32 + b] + acc;
      v = v > 3.0e38f ? 3.0e38f : v;
      v = v < -3.0e38f ? -3.0e38f : v;
      out[k * 32 + b] = v;
      if (do_part) {
        double a = v < 0 ? -(double)v : (double)v;
        if (a > amax) amax = a;
        ssum += (double)v * (double)v;
        sabs += a;
      }
    }
  }
  int64_t base = full * 32;
  if (n % 32 && n / 32 >= w0 && n / 32 < w1) {
    base = (n / 32) * 32;
    int64_t pw = n / 32;
    for (int64_t b = 0; b < n - base; b++) {
      float acc = 0.0f;
      for (int f = 0; f < m; f++) {
        float s = svals[f];
        acc += ((wps[f][pw] >> b) & 1u) ? -s : s;
      }
      float v = in[base + b] + acc;
      v = v > 3.0e38f ? 3.0e38f : v;
      v = v < -3.0e38f ? -3.0e38f : v;
      out[base + b] = v;
      if (do_part) {
        double a = v < 0 ? -(double)v : (double)v;
        if (a > amax) amax = a;
        ssum += (double)v * (double)v;
        sabs += a;
      }
    }
    for (int64_t b = n - base; b < 32 && base + b < pad; b++)
      out[base + b] = in[base + b];
    base += 32;
  }
  if (base < w0 * 32) base = w0 * 32;
  int64_t end = w1 * 32;
  if (base < end && base < pad) {
    int64_t stop = end < pad ? end : pad;
    if (stop > base)
      memcpy(out + base, in + base, (size_t)(stop - base) * sizeof(float));
  }
  if (out_amax) {
    *out_amax = amax;
    *out_ss = ssum;
    *out_sabs = sabs;
  }
}

/* idle-leaf range: copy + optional partials of the (unchanged) live lanes */
ST_CLONES
static void copy_partials_range(const float *in, float *out, int64_t n,
                                int64_t pad, int64_t e0, int64_t e1,
                                double *out_amax, double *out_ss,
                                double *out_sabs) {
  if (out != in) {
    int64_t stop = e1 < pad ? e1 : pad;
    if (stop > e0)
      memcpy(out + e0, in + e0, (size_t)(stop - e0) * sizeof(float));
  }
  if (out_amax) {
    int64_t live = n < e1 ? n : e1;
    scale_partials_range(out, e0 < live ? e0 : live, live, out_amax, out_ss,
                         out_sabs);
  }
}

typedef struct {
  const float *vin;
  float *vout;
  const int64_t *off, *ns, *padded;
  int64_t W;
  int32_t k;
  const float *scales;
  const uint32_t *words;
  double *camax, *css, *csabs;
#ifdef ST_POOL
  const stc_chunk *chunks;
#endif
  /* per-leaf active-frame table, built once by the wrapper: for leaf i,
   * frames af[i*k .. i*k+am[i]) are the nonzero-scale ones */
  const uint32_t *const *wps; /* [L * k] word pointers */
  const float *svals;         /* [L * k] scales */
  const int32_t *am;          /* [L] active counts */
} af_ctx;

static void apply_frames_leaf_range(af_ctx *x, int64_t i, int64_t w0,
                                    int64_t w1, double *pa, double *ps,
                                    double *pb) {
  int m = x->am[i];
  if (m == 0) {
    copy_partials_range(x->vin + x->off[i], x->vout + x->off[i], x->ns[i],
                        x->padded[i], w0 * 32, w1 * 32, pa, ps, pb);
    return;
  }
  apply_frames_range(x->vin + x->off[i], x->vout + x->off[i],
                     x->wps + (size_t)i * x->k, x->svals + (size_t)i * x->k, m,
                     x->ns[i], x->padded[i], w0, w1, pa, ps, pb);
}

#ifdef ST_POOL
static void apply_frames_seg(void *vctx, int64_t c) {
  af_ctx *x = (af_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  apply_frames_leaf_range(x, ch->leaf, ch->w0, ch->w1,
                          x->camax ? &x->camax[c] : NULL,
                          x->camax ? &x->css[c] : NULL,
                          x->camax ? &x->csabs[c] : NULL);
}
#endif

/* shared tail of the fused-apply wrappers (flat and wire layouts build
 * the same per-leaf pointer tables, then run identically) */
static void apply_frames_run(af_ctx *x, int64_t n_leaves,
                             const int64_t *padded, double *out_amax,
                             double *out_ss, double *out_sabs) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    double *pbuf =
        out_amax ? (double *)malloc((size_t)nc * 3 * sizeof(double)) : NULL;
    if (chunks && (!out_amax || pbuf)) {
      stc_build_chunks(padded, n_leaves, chunks);
      x->chunks = chunks;
      x->camax = pbuf;
      x->css = pbuf ? pbuf + nc : NULL;
      x->csabs = pbuf ? pbuf + 2 * nc : NULL;
      if (stc_pool_run(apply_frames_seg, x, nc)) {
        if (out_amax)
          reduce_chunk_partials(chunks, nc, n_leaves, x->camax, x->css,
                                x->csabs, out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
      x->camax = NULL;
      x->css = NULL;
      x->csabs = NULL;
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    apply_frames_leaf_range(x, i, 0, padded[i] / 32,
                            out_amax ? &out_amax[i] : NULL,
                            out_amax ? &out_ss[i] : NULL,
                            out_amax ? &out_sabs[i] : NULL);
  }
}

EXPORT void stc_apply_frames(const float *vin, float *vout, const int64_t *off,
                             const int64_t *ns, const int64_t *padded,
                             int64_t n_leaves, int64_t W, int32_t k,
                             const float *scales /* k*L */,
                             const uint32_t *words /* k*W */,
                             double *out_amax, double *out_ss,
                             double *out_sabs) {
  if (k <= 0) return;
  /* active-frame table: per leaf, the frames whose scale is nonzero */
  const uint32_t **wps =
      (const uint32_t **)malloc((size_t)n_leaves * k * sizeof(uint32_t *));
  float *svals = (float *)malloc((size_t)n_leaves * k * sizeof(float));
  int32_t *am = (int32_t *)malloc((size_t)n_leaves * sizeof(int32_t));
  if (!wps || !svals || !am) {
    /* OOM: frame-at-a-time fallback — ~1 ulp off the fused path for k > 1
     * (per-frame clamp + rounding; see the kernel header's EXCEPTION) */
    free(wps);
    free(svals);
    free(am);
    for (int32_t f = 0; f < k; f++)
      stc_apply_frame(f == 0 ? vin : vout, vout, off, ns, padded, n_leaves,
                      scales + (size_t)f * n_leaves, words + (size_t)f * W);
    if (out_amax)
      stc_scale_partials(vout, off, ns, n_leaves, out_amax, out_ss, out_sabs);
    return;
  }
  for (int64_t i = 0; i < n_leaves; i++) {
    int32_t m = 0;
    for (int32_t f = 0; f < k; f++) {
      float s = scales[(size_t)f * n_leaves + i];
      if (s == 0.0f) continue;
      wps[(size_t)i * k + m] = words + (size_t)f * W + off[i] / 32;
      svals[(size_t)i * k + m] = s;
      m++;
    }
    am[i] = m;
  }
  af_ctx x;
  x.vin = vin;
  x.vout = vout;
  x.off = off;
  x.ns = ns;
  x.padded = padded;
  x.W = W;
  x.k = k;
  x.scales = scales;
  x.words = words;
  x.camax = NULL;
  x.css = NULL;
  x.csabs = NULL;
  x.wps = wps;
  x.svals = svals;
  x.am = am;
  apply_frames_run(&x, n_leaves, padded, out_amax, out_ss, out_sabs);
  free(wps);
  free(svals);
  free(am);
}

/* r14: fused k-frame apply STRAIGHT FROM THE WIRE BODY — per frame f the
 * layout is [scales L*4][words W*4] at body + f*stride (the v3 aligned
 * framing guarantees body and stride are 4-aligned, so the typed loads
 * are legal). Identical arithmetic to stc_apply_frames: the workers only
 * ever see the per-leaf pointer table, which here points into the wire
 * buffer instead of a repacked copy — the receive path's full-message
 * repack (one read + one write of every wire byte) disappears. */
EXPORT void stc_apply_frames_wire(const float *vin, float *vout,
                                  const int64_t *off, const int64_t *ns,
                                  const int64_t *padded, int64_t n_leaves,
                                  int64_t W, int32_t k, const uint8_t *body,
                                  int64_t stride, double *out_amax,
                                  double *out_ss, double *out_sabs) {
  if (k <= 0) return;
  const uint32_t **wps =
      (const uint32_t **)malloc((size_t)n_leaves * k * sizeof(uint32_t *));
  float *svals = (float *)malloc((size_t)n_leaves * k * sizeof(float));
  int32_t *am = (int32_t *)malloc((size_t)n_leaves * sizeof(int32_t));
  if (!wps || !svals || !am) {
    free(wps);
    free(svals);
    free(am);
    for (int32_t f = 0; f < k; f++) {
      const uint8_t *fb = body + (size_t)f * stride;
      stc_apply_frame(f == 0 ? vin : vout, vout, off, ns, padded, n_leaves,
                      (const float *)fb,
                      (const uint32_t *)(fb + 4 * n_leaves));
    }
    if (out_amax)
      stc_scale_partials(vout, off, ns, n_leaves, out_amax, out_ss, out_sabs);
    return;
  }
  for (int64_t i = 0; i < n_leaves; i++) {
    int32_t m = 0;
    for (int32_t f = 0; f < k; f++) {
      const uint8_t *fb = body + (size_t)f * stride;
      float s = ((const float *)fb)[i];
      if (s == 0.0f) continue;
      wps[(size_t)i * k + m] =
          (const uint32_t *)(fb + 4 * n_leaves) + off[i] / 32;
      svals[(size_t)i * k + m] = s;
      m++;
    }
    am[i] = m;
  }
  af_ctx x;
  x.vin = vin;
  x.vout = vout;
  x.off = off;
  x.ns = ns;
  x.padded = padded;
  x.W = W;
  x.k = k;
  x.scales = NULL; /* workers read only the pointer tables */
  x.words = NULL;
  x.camax = NULL;
  x.css = NULL;
  x.csabs = NULL;
  x.wps = wps;
  x.svals = svals;
  x.am = am;
  apply_frames_run(&x, n_leaves, padded, out_amax, out_ss, out_sabs);
  free(wps);
  free(svals);
  free(am);
}

/* ======================================================================
 * r11: cascade quantize + sign2 (2-bit) kernels — the data-plane codecs
 * behind the next-10x arc (ROADMAP item 4).
 *
 * CASCADE QUANTIZE. The r07 burst sender quantizes K successive frames
 * of one residual as K full memory passes (each stc_quantize_ef_partials
 * call re-reads and re-writes the whole table), because frame k+1's scale
 * is re-measured from frame k's output. Measured on this box at 1 Mi that
 * pass is ~150 us and the pool's intra-pass parallelism has already
 * flattened — the PASS COUNT is the wall, not the bandwidth (the box
 * streams ~600 GB/s; the sender chain uses ~70). But scales are
 * SENDER-CHOSEN and ride the wire (receivers never recompute them), so a
 * sender may legally emit a frame schedule it predicts instead of
 * measures: successive halvings s, s/2, s/4, ... — which is exactly what
 * the measured schedule converges to anyway (pow2-RMS decays ~0.85/frame
 * => the pow2 floor halves every few frames), taken one frame earlier.
 * These kernels quantize K such frames in ONE pass, carrying the element
 * in registers across the K subtractions and emitting K bit planes: K
 * frames for one table read + one write + K/32 words. The wire format is
 * UNCHANGED — a cascade message is indistinguishable from K re-measured
 * frames, and the fused receive (stc_apply_frames) already applies K
 * frames in one pass. After a cascade the residual magnitude is bounded
 * by ~s/2^(K-1) (each level halves the bound), so per-message drain is
 * deeper than the measured schedule's, at identical bytes per frame.
 *
 * SIGN2 (2-bit sign/magnitude). The codec-lab winner (ops/codec_lab.py
 * Sign2, parallel/ici_lab.py build_sign2_sync_step) promoted to the
 * engine tier: sign bit + magnitude bit selecting +/-s or +/-3s
 * (magnitude set when |r| > 2s), zero-negative sign convention kept
 * (quirk Q3). Both magnitudes are exact f32 multiples of a pow2 scale
 * (3s has a 1.5 mantissa) so the 1-ulp conservation bound carries over.
 * Wire layout per frame: [scales L*4][sign words W*4][mag words W*4] —
 * two packed planes, the lab's exact layout. On a uniform residual the
 * magnitude bit idles and the trajectory is bit-identical to sign1; on
 * gaussian/outlier-heavy residuals (retransmit rollbacks, chaos) the
 * +/-3s level drains the tail 3x faster per frame — which is what the
 * engine's telemetry governor upshifts for (stengine.cpp).
 * ==================================================================== */

/* K halving levels for words [w0, w1) of one leaf. scales[j] is frame j's
 * scale for THIS leaf (any schedule; s == 0 levels record sign bits and
 * leave the residual untouched, stc_quantize's idle-leaf semantics).
 * Frame j's plane for this leaf lands at wp + j*wstride (wp already
 * offset to the leaf). Partials are of the FINAL residual. */
ST_CLONES
static void quantize_cascade_range(const float *p, float *q, int64_t n,
                                   const float *scales, int32_t k,
                                   uint32_t *wp, int64_t wstride, int64_t w0,
                                   int64_t w1, double *out_amax,
                                   double *out_ss, double *out_sabs) {
  double amax = 0, ssum = 0, sabs = 0;
  for (int64_t w = w0; w < w1; w++) {
    int64_t base = w * 32;
    int64_t lim = n - base;
    if (lim > 32) lim = 32;
    if (lim < 0) lim = 0;
    float buf[32];
    for (int64_t b = 0; b < lim; b++) buf[b] = p[base + b];
    for (int32_t j = 0; j < k; j++) {
      uint32_t bits = 0;
      float s = scales[j];
      if (s > 0.0f) {
        for (int64_t b = 0; b < lim; b++) {
          float v = buf[b];
          uint32_t neg = v <= 0.0f;
          bits |= neg << b;
          buf[b] = v - (neg ? -s : s);
        }
      } else {
        for (int64_t b = 0; b < lim; b++)
          bits |= (uint32_t)(buf[b] <= 0.0f) << b;
      }
      wp[(size_t)j * wstride + w] = bits;
    }
    for (int64_t b = 0; b < lim; b++) {
      float r = buf[b];
      q[base + b] = r;
      double a = r < 0 ? -(double)r : (double)r;
      if (a > amax) amax = a;
      ssum += (double)r * (double)r;
      sabs += a;
    }
    for (int64_t b = lim; b < 32; b++) q[base + b] = 0.0f;
  }
  *out_amax = amax;
  *out_ss = ssum;
  *out_sabs = sabs;
}

#ifdef ST_AVX512
/* Full-word AVX-512 body of the cascade: two 16-lane vectors stay in
 * registers across all K levels; partials of the final residual fused
 * (quantize_partials_leaf_avx512's arithmetic). Covers words
 * [w0, min(w1, n/32)); returns the stopping word. */
ST_TARGET_AVX512
static int64_t quantize_cascade_leaf_avx512(const float *p, float *q,
                                            int64_t n, const float *scales,
                                            int32_t k, uint32_t *wp,
                                            int64_t wstride, int64_t w0,
                                            int64_t w1, double *amax,
                                            double *ss, double *sabs) {
  const __m512 vzero = _mm512_setzero_ps();
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t w = w0, wl = n / 32 < w1 ? n / 32 : w1;
  for (; w < wl; w++) {
    __m512 v0 = _mm512_loadu_ps(p + w * 32);
    __m512 v1 = _mm512_loadu_ps(p + w * 32 + 16);
    for (int32_t j = 0; j < k; j++) {
      __mmask16 m0 = _mm512_cmp_ps_mask(v0, vzero, _CMP_LE_OQ);
      __mmask16 m1 = _mm512_cmp_ps_mask(v1, vzero, _CMP_LE_OQ);
      float s = scales[j];
      if (s > 0.0f) {
        const __m512i vs = _mm512_castps_si512(_mm512_set1_ps(s));
        __m512 d0 =
            _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m0, vs, vsign));
        __m512 d1 =
            _mm512_castsi512_ps(_mm512_mask_xor_epi32(vs, m1, vs, vsign));
        v0 = _mm512_sub_ps(v0, d0);
        v1 = _mm512_sub_ps(v1, d1);
      }
      wp[(size_t)j * wstride + w] = (uint32_t)m0 | ((uint32_t)m1 << 16);
    }
    _mm512_storeu_ps(q + w * 32, v0);
    _mm512_storeu_ps(q + w * 32 + 16, v1);
    __m512 a0 = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(v0), vabsmask));
    __m512 a1 = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(v1), vabsmask));
    vamax = _mm512_max_ps(vamax, _mm512_max_ps(a0, a1));
    __m512d lo0 = _mm512_cvtps_pd(_mm512_castps512_ps256(v0));
    __m512d hi0 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(v0, 1));
    __m512d lo1 = _mm512_cvtps_pd(_mm512_castps512_ps256(v1));
    __m512d hi1 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(v1, 1));
    vss0 = _mm512_fmadd_pd(lo0, lo0, vss0);
    vss1 = _mm512_fmadd_pd(hi0, hi0, vss1);
    vss0 = _mm512_fmadd_pd(lo1, lo1, vss0);
    vss1 = _mm512_fmadd_pd(hi1, hi1, vss1);
    vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a0)));
    vsa1 = _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a0, 1)));
    vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a1)));
    vsa1 = _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a1, 1)));
  }
  *amax = _mm512_reduce_max_ps(vamax);
  *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
  *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  return w;
}
#endif

/* Range body with runtime AVX-512 dispatch (full words vectorized, the
 * live-tail word + partial-word handling stays scalar). */
static void quantize_cascade_dispatch(const float *p, float *q, int64_t n,
                                      const float *scales, int32_t k,
                                      uint32_t *wp, int64_t wstride,
                                      int64_t w0, int64_t w1, double *oa,
                                      double *os, double *ob) {
  int64_t w = w0;
  double a2 = 0, s2 = 0, b2 = 0;
#ifdef ST_AVX512
  if (st_has_avx512() && w < w1 && n / 32 > w0) {
    w = quantize_cascade_leaf_avx512(p, q, n, scales, k, wp, wstride, w0, w1,
                                     &a2, &s2, &b2);
  }
#endif
  double a3 = 0, s3 = 0, b3 = 0;
  if (w < w1)
    quantize_cascade_range(p, q, n, scales, k, wp, wstride, w, w1, &a3, &s3,
                           &b3);
  *oa = a2 > a3 ? a2 : a3;
  *os = s2 + s3;
  *ob = b2 + b3;
}

#ifdef ST_POOL
typedef struct {
  const float *rin;
  float *rout;
  const int64_t *off, *ns;
  const float *scales; /* k * L */
  int64_t n_leaves;
  int32_t k;
  uint32_t *words;
  int64_t wstride;
  const stc_chunk *chunks;
  double *camax, *css, *csabs;
} qzc_ctx;

static void quantize_cascade_seg(void *vctx, int64_t c) {
  qzc_ctx *x = (qzc_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  /* per-leaf schedule column: frame j's scale for leaf i */
  float ls[64];
  for (int32_t j = 0; j < x->k; j++)
    ls[j] = x->scales[(size_t)j * x->n_leaves + i];
  quantize_cascade_dispatch(x->rin + x->off[i], x->rout + x->off[i],
                            x->ns[i], ls, x->k, x->words + x->off[i] / 32,
                            x->wstride, ch->w0, ch->w1, &x->camax[c],
                            &x->css[c], &x->csabs[c]);
}
#endif

/* K frames in ONE pass over the residual. scales is k*L (frame-major, the
 * schedule the caller chose — stengine.cpp halves frame 0's measured
 * scales); frame j's bit plane lands at words + j*wstride (wstride in u32
 * words — the engine passes its wire-frame stride so planes land at their
 * final slot offsets). Partials (per leaf, of the final residual) feed the
 * next message's frame-0 scales exactly like stc_quantize_ef_partials.
 * k is capped at 64 (the engine never asks for more — a cascade below
 * s/2^63 is denormal territory long before). */
EXPORT void stc_quantize_ef_cascade(
    const float *rin, float *rout, const int64_t *off, const int64_t *ns,
    const int64_t *padded, int64_t n_leaves, int32_t k, const float *scales,
    uint32_t *words, int64_t wstride, double *out_amax, double *out_ss,
    double *out_sabs) {
  if (k < 1) k = 1;
  if (k > 64) k = 64;
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    double *pbuf = (double *)malloc((size_t)nc * 3 * sizeof(double));
    if (chunks && pbuf) {
      stc_build_chunks(padded, n_leaves, chunks);
      qzc_ctx x = {rin,   rout,    off,  ns,        scales,
                   n_leaves, k,    words, wstride,  chunks,
                   pbuf,  pbuf + nc, pbuf + 2 * nc};
      if (stc_pool_run(quantize_cascade_seg, &x, nc)) {
        reduce_chunk_partials(chunks, nc, n_leaves, x.camax, x.css, x.csabs,
                              out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    float ls[64];
    for (int32_t j = 0; j < k; j++)
      ls[j] = scales[(size_t)j * n_leaves + i];
    quantize_cascade_dispatch(rin + off[i], rout + off[i], ns[i], ls, k,
                              words + off[i] / 32, wstride, 0, padded[i] / 32,
                              &out_amax[i], &out_ss[i], &out_sabs[i]);
  }
}

/* sign2 cascade: K levels of the 2-bit rule in one pass. Frame j's sign
 * plane lands at wp + j*wstride, its magnitude plane W words after (the
 * wire layout: [scales][sign W][mag W] per frame). Level semantics match
 * the lab reference exactly: neg = r <= 0, big = |r| > 2s (with s == 0
 * that is |r| > 0 — bits still recorded, residual untouched, the
 * idle-leaf twin of the 1-bit kernels). */
ST_CLONES
static void quantize2_cascade_range(const float *p, float *q, int64_t n,
                                    const float *scales, int32_t k,
                                    uint32_t *wp, int64_t wstride, int64_t W,
                                    int64_t w0, int64_t w1, double *out_amax,
                                    double *out_ss, double *out_sabs) {
  double amax = 0, ssum = 0, sabs = 0;
  for (int64_t w = w0; w < w1; w++) {
    int64_t base = w * 32;
    int64_t lim = n - base;
    if (lim > 32) lim = 32;
    if (lim < 0) lim = 0;
    float buf[32];
    for (int64_t b = 0; b < lim; b++) buf[b] = p[base + b];
    for (int32_t j = 0; j < k; j++) {
      uint32_t sbits = 0, mbits = 0;
      float s = scales[j];
      float s2x = 2.0f * s, s3x = 3.0f * s;
      for (int64_t b = 0; b < lim; b++) {
        float v = buf[b];
        uint32_t neg = v <= 0.0f;
        float av = v < 0.0f ? -v : v;
        uint32_t big = av > s2x;
        sbits |= neg << b;
        mbits |= big << b;
        if (s > 0.0f) {
          float mag = big ? s3x : s;
          buf[b] = v - (neg ? -mag : mag);
        }
      }
      wp[(size_t)j * wstride + w] = sbits;
      wp[(size_t)j * wstride + W + w] = mbits;
    }
    for (int64_t b = 0; b < lim; b++) {
      float r = buf[b];
      q[base + b] = r;
      double a = r < 0 ? -(double)r : (double)r;
      if (a > amax) amax = a;
      ssum += (double)r * (double)r;
      sabs += a;
    }
    for (int64_t b = lim; b < 32; b++) q[base + b] = 0.0f;
  }
  *out_amax = amax;
  *out_ss = ssum;
  *out_sabs = sabs;
}

#ifdef ST_AVX512
/* Full-word AVX-512 body of the sign2 cascade (quantize_cascade_leaf_
 * avx512's 2-bit twin): the element rides registers across all K levels;
 * per level, two compare masks ARE the wire planes (neg -> sign bits,
 * |v| > 2s -> magnitude bits) and the subtrahend is the magnitude blend
 * (+/-s or +/-3s) sign-flipped by mask — bit- and ulp-identical to the
 * scalar rule (2.0f*s / 3.0f*s precomputed in f32 exactly like it).
 * Covers words [w0, min(w1, n/32)); returns the stopping word. */
ST_TARGET_AVX512
static int64_t quantize2_cascade_leaf_avx512(
    const float *p, float *q, int64_t n, const float *scales, int32_t k,
    uint32_t *wp, int64_t wstride, int64_t W, int64_t w0, int64_t w1,
    double *amax, double *ss, double *sabs) {
  const __m512 vzero = _mm512_setzero_ps();
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t w = w0, wl = n / 32 < w1 ? n / 32 : w1;
  for (; w < wl; w++) {
    __m512 v0 = _mm512_loadu_ps(p + w * 32);
    __m512 v1 = _mm512_loadu_ps(p + w * 32 + 16);
    for (int32_t j = 0; j < k; j++) {
      float s = scales[j];
      const __m512 vs2 = _mm512_set1_ps(2.0f * s);
      __mmask16 n0 = _mm512_cmp_ps_mask(v0, vzero, _CMP_LE_OQ);
      __mmask16 n1 = _mm512_cmp_ps_mask(v1, vzero, _CMP_LE_OQ);
      __m512 a0 = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(v0), vabsmask));
      __m512 a1 = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(v1), vabsmask));
      __mmask16 b0 = _mm512_cmp_ps_mask(a0, vs2, _CMP_GT_OQ);
      __mmask16 b1 = _mm512_cmp_ps_mask(a1, vs2, _CMP_GT_OQ);
      if (s > 0.0f) {
        const __m512 vs = _mm512_set1_ps(s);
        const __m512 vs3 = _mm512_set1_ps(3.0f * s);
        __m512i mag0 = _mm512_castps_si512(_mm512_mask_mov_ps(vs, b0, vs3));
        __m512i mag1 = _mm512_castps_si512(_mm512_mask_mov_ps(vs, b1, vs3));
        __m512 d0 =
            _mm512_castsi512_ps(_mm512_mask_xor_epi32(mag0, n0, mag0, vsign));
        __m512 d1 =
            _mm512_castsi512_ps(_mm512_mask_xor_epi32(mag1, n1, mag1, vsign));
        v0 = _mm512_sub_ps(v0, d0);
        v1 = _mm512_sub_ps(v1, d1);
      }
      wp[(size_t)j * wstride + w] = (uint32_t)n0 | ((uint32_t)n1 << 16);
      wp[(size_t)j * wstride + W + w] = (uint32_t)b0 | ((uint32_t)b1 << 16);
    }
    _mm512_storeu_ps(q + w * 32, v0);
    _mm512_storeu_ps(q + w * 32 + 16, v1);
    __m512 a0 = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(v0), vabsmask));
    __m512 a1 = _mm512_castsi512_ps(
        _mm512_and_epi32(_mm512_castps_si512(v1), vabsmask));
    vamax = _mm512_max_ps(vamax, _mm512_max_ps(a0, a1));
    __m512d lo0 = _mm512_cvtps_pd(_mm512_castps512_ps256(v0));
    __m512d hi0 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(v0, 1));
    __m512d lo1 = _mm512_cvtps_pd(_mm512_castps512_ps256(v1));
    __m512d hi1 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(v1, 1));
    vss0 = _mm512_fmadd_pd(lo0, lo0, vss0);
    vss1 = _mm512_fmadd_pd(hi0, hi0, vss1);
    vss0 = _mm512_fmadd_pd(lo1, lo1, vss0);
    vss1 = _mm512_fmadd_pd(hi1, hi1, vss1);
    vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a0)));
    vsa1 = _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a0, 1)));
    vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a1)));
    vsa1 = _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a1, 1)));
  }
  *amax = _mm512_reduce_max_ps(vamax);
  *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
  *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  return w;
}
#endif

/* Range body with runtime AVX-512 dispatch (full words vectorized, the
 * live-tail word + partial-word handling stays scalar — same split as
 * quantize_cascade_dispatch). */
static void quantize2_cascade_dispatch(const float *p, float *q, int64_t n,
                                       const float *scales, int32_t k,
                                       uint32_t *wp, int64_t wstride,
                                       int64_t W, int64_t w0, int64_t w1,
                                       double *oa, double *os, double *ob) {
  int64_t w = w0;
  double a2 = 0, s2 = 0, b2 = 0;
#ifdef ST_AVX512
  if (st_has_avx512() && w < w1 && n / 32 > w0) {
    w = quantize2_cascade_leaf_avx512(p, q, n, scales, k, wp, wstride, W, w0,
                                      w1, &a2, &s2, &b2);
  }
#endif
  double a3 = 0, s3 = 0, b3 = 0;
  if (w < w1)
    quantize2_cascade_range(p, q, n, scales, k, wp, wstride, W, w, w1, &a3,
                            &s3, &b3);
  *oa = a2 > a3 ? a2 : a3;
  *os = s2 + s3;
  *ob = b2 + b3;
}

#ifdef ST_POOL
typedef struct {
  const float *rin;
  float *rout;
  const int64_t *off, *ns;
  const float *scales;
  int64_t n_leaves;
  int32_t k;
  uint32_t *words;
  int64_t wstride, W;
  const stc_chunk *chunks;
  double *camax, *css, *csabs;
} qz2_ctx;

static void quantize2_cascade_seg(void *vctx, int64_t c) {
  qz2_ctx *x = (qz2_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  int64_t i = ch->leaf;
  float ls[64];
  for (int32_t j = 0; j < x->k; j++)
    ls[j] = x->scales[(size_t)j * x->n_leaves + i];
  quantize2_cascade_dispatch(x->rin + x->off[i], x->rout + x->off[i],
                             x->ns[i], ls, x->k, x->words + x->off[i] / 32,
                             x->wstride, x->W, ch->w0, ch->w1, &x->camax[c],
                             &x->css[c], &x->csabs[c]);
}
#endif

/* The sign2 sender kernel (k = 1 is the plain per-frame quantize the
 * parity tests pin against the JAX lab). words/wstride as in
 * stc_quantize_ef_cascade; W is the table's total word count (locates the
 * magnitude plane inside each frame). */
EXPORT void stc_quantize2_ef_cascade(
    const float *rin, float *rout, const int64_t *off, const int64_t *ns,
    const int64_t *padded, int64_t n_leaves, int32_t k, const float *scales,
    uint32_t *words, int64_t wstride, int64_t W, double *out_amax,
    double *out_ss, double *out_sabs) {
  if (k < 1) k = 1;
  if (k > 64) k = 64;
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    double *pbuf = (double *)malloc((size_t)nc * 3 * sizeof(double));
    if (chunks && pbuf) {
      stc_build_chunks(padded, n_leaves, chunks);
      qz2_ctx x = {rin,      rout, off,   ns,      scales, n_leaves, k,
                   words,    wstride, W,  chunks,  pbuf,   pbuf + nc,
                   pbuf + 2 * nc};
      if (stc_pool_run(quantize2_cascade_seg, &x, nc)) {
        reduce_chunk_partials(chunks, nc, n_leaves, x.camax, x.css, x.csabs,
                              out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    float ls[64];
    for (int32_t j = 0; j < k; j++)
      ls[j] = scales[(size_t)j * n_leaves + i];
    quantize2_cascade_dispatch(rin + off[i], rout + off[i], ns[i], ls, k,
                               words + off[i] / 32, wstride, W, 0,
                               padded[i] / 32, &out_amax[i], &out_ss[i],
                               &out_sabs[i]);
  }
}

/* ---- sign2 receive: fused k-frame apply --------------------------------
 * delta = s * (sign ? -1 : +1) * (mag ? 3 : 1), summed across the active
 * frames, one pass per target, +/-3e38 clamp at the end — the sign2 twin
 * of apply_frames_range (same ~1-ulp note vs per-frame application). */

#ifdef ST_AVX512
/* whole live words [w0, wl): the per-frame subtrahend is the magnitude
 * blend (s or 3.0f*s by the mag plane) sign-flipped by the sign plane —
 * apply_frames_avx512 with one extra mask_mov per frame, ulp-identical
 * to the scalar accumulation order. */
ST_TARGET_AVX512
static int64_t apply2_frames_avx512(const float *in, float *out,
                                    const uint32_t *const *sps,
                                    const uint32_t *const *mps,
                                    const float *svals, int m, int64_t wl,
                                    int64_t w0, int do_part, double *amax,
                                    double *ss, double *sabs) {
  const __m512i vsign = _mm512_set1_epi32((int32_t)0x80000000u);
  const __m512 vmax = _mm512_set1_ps(3.0e38f);
  const __m512 vmin = _mm512_set1_ps(-3.0e38f);
  const __m512i vabsmask = _mm512_set1_epi32(0x7FFFFFFF);
  __m512 vamax = _mm512_setzero_ps();
  __m512d vss0 = _mm512_setzero_pd(), vss1 = _mm512_setzero_pd();
  __m512d vsa0 = _mm512_setzero_pd(), vsa1 = _mm512_setzero_pd();
  int64_t w = w0;
  for (; w < wl; w++) {
    __m512 acc0 = _mm512_setzero_ps();
    __m512 acc1 = _mm512_setzero_ps();
    for (int f = 0; f < m; f++) {
      uint32_t sb = sps[f][w], mb = mps[f][w];
      const __m512 vs = _mm512_set1_ps(svals[f]);
      const __m512 vs3 = _mm512_set1_ps(3.0f * svals[f]);
      __m512i mag0 = _mm512_castps_si512(
          _mm512_mask_mov_ps(vs, (__mmask16)mb, vs3));
      __m512i mag1 = _mm512_castps_si512(
          _mm512_mask_mov_ps(vs, (__mmask16)(mb >> 16), vs3));
      acc0 = _mm512_add_ps(
          acc0, _mm512_castsi512_ps(_mm512_mask_xor_epi32(
                    mag0, (__mmask16)sb, mag0, vsign)));
      acc1 = _mm512_add_ps(
          acc1, _mm512_castsi512_ps(_mm512_mask_xor_epi32(
                    mag1, (__mmask16)(sb >> 16), mag1, vsign)));
    }
    const float *pp = in + w * 32;
    float *qq = out + w * 32;
    __m512 r0 = _mm512_add_ps(_mm512_loadu_ps(pp), acc0);
    __m512 r1 = _mm512_add_ps(_mm512_loadu_ps(pp + 16), acc1);
    r0 = _mm512_max_ps(_mm512_min_ps(r0, vmax), vmin);
    r1 = _mm512_max_ps(_mm512_min_ps(r1, vmax), vmin);
    _mm512_storeu_ps(qq, r0);
    _mm512_storeu_ps(qq + 16, r1);
    if (do_part) {
      __m512 a0 = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(r0), vabsmask));
      __m512 a1 = _mm512_castsi512_ps(
          _mm512_and_epi32(_mm512_castps_si512(r1), vabsmask));
      vamax = _mm512_max_ps(vamax, _mm512_max_ps(a0, a1));
      __m512d lo0 = _mm512_cvtps_pd(_mm512_castps512_ps256(r0));
      __m512d hi0 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(r0, 1));
      __m512d lo1 = _mm512_cvtps_pd(_mm512_castps512_ps256(r1));
      __m512d hi1 = _mm512_cvtps_pd(_mm512_extractf32x8_ps(r1, 1));
      vss0 = _mm512_fmadd_pd(lo0, lo0, vss0);
      vss1 = _mm512_fmadd_pd(hi0, hi0, vss1);
      vss0 = _mm512_fmadd_pd(lo1, lo1, vss0);
      vss1 = _mm512_fmadd_pd(hi1, hi1, vss1);
      vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a0)));
      vsa1 =
          _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a0, 1)));
      vsa0 = _mm512_add_pd(vsa0, _mm512_cvtps_pd(_mm512_castps512_ps256(a1)));
      vsa1 =
          _mm512_add_pd(vsa1, _mm512_cvtps_pd(_mm512_extractf32x8_ps(a1, 1)));
    }
  }
  if (do_part) {
    *amax = _mm512_reduce_max_ps(vamax);
    *ss = _mm512_reduce_add_pd(vss0) + _mm512_reduce_add_pd(vss1);
    *sabs = _mm512_reduce_add_pd(vsa0) + _mm512_reduce_add_pd(vsa1);
  }
  return w;
}
#endif

ST_CLONES
static void apply2_frames_range(const float *in, float *out,
                                const uint32_t *const *sps,
                                const uint32_t *const *mps,
                                const float *svals, int m, int64_t n,
                                int64_t pad, int64_t w0, int64_t w1,
                                double *out_amax, double *out_ss,
                                double *out_sabs) {
  double amax = 0, ssum = 0, sabs = 0;
  int64_t full = n / 32;
  if (full > w1) full = w1;
  int do_part = out_amax != NULL;
  int64_t k = w0;
#ifdef ST_AVX512
  if (st_has_avx512() && k < full) {
    double a2 = 0, s2 = 0, b2 = 0;
    k = apply2_frames_avx512(in, out, sps, mps, svals, m, full, w0, do_part,
                             &a2, &s2, &b2);
    if (do_part) {
      amax = a2;
      ssum = s2;
      sabs = b2;
    }
  }
#endif
  for (; k < full; k++) {
    for (int b = 0; b < 32; b++) {
      float acc = 0.0f;
      for (int f = 0; f < m; f++) {
        float s = svals[f];
        float d = ((mps[f][k] >> b) & 1u) ? 3.0f * s : s;
        acc += ((sps[f][k] >> b) & 1u) ? -d : d;
      }
      float v = in[k * 32 + b] + acc;
      v = v > 3.0e38f ? 3.0e38f : v;
      v = v < -3.0e38f ? -3.0e38f : v;
      out[k * 32 + b] = v;
      if (do_part) {
        double a = v < 0 ? -(double)v : (double)v;
        if (a > amax) amax = a;
        ssum += (double)v * (double)v;
        sabs += a;
      }
    }
  }
  int64_t base = full * 32;
  if (n % 32 && n / 32 >= w0 && n / 32 < w1) {
    base = (n / 32) * 32;
    int64_t pw = n / 32;
    for (int64_t b = 0; b < n - base; b++) {
      float acc = 0.0f;
      for (int f = 0; f < m; f++) {
        float s = svals[f];
        float d = ((mps[f][pw] >> b) & 1u) ? 3.0f * s : s;
        acc += ((sps[f][pw] >> b) & 1u) ? -d : d;
      }
      float v = in[base + b] + acc;
      v = v > 3.0e38f ? 3.0e38f : v;
      v = v < -3.0e38f ? -3.0e38f : v;
      out[base + b] = v;
      if (do_part) {
        double a = v < 0 ? -(double)v : (double)v;
        if (a > amax) amax = a;
        ssum += (double)v * (double)v;
        sabs += a;
      }
    }
    for (int64_t b = n - base; b < 32 && base + b < pad; b++)
      out[base + b] = in[base + b];
    base += 32;
  }
  if (base < w0 * 32) base = w0 * 32;
  int64_t end = w1 * 32;
  if (base < end && base < pad) {
    int64_t stop = end < pad ? end : pad;
    if (stop > base)
      memcpy(out + base, in + base, (size_t)(stop - base) * sizeof(float));
  }
  if (out_amax) {
    *out_amax = amax;
    *out_ss = ssum;
    *out_sabs = sabs;
  }
}

typedef struct {
  const float *vin;
  float *vout;
  const int64_t *off, *ns, *padded;
  int64_t W;
  int32_t k;
  double *camax, *css, *csabs;
#ifdef ST_POOL
  const stc_chunk *chunks;
#endif
  const uint32_t *const *sps; /* [L * k] sign-plane pointers */
  const uint32_t *const *mps; /* [L * k] mag-plane pointers */
  const float *svals;         /* [L * k] scales */
  const int32_t *am;          /* [L] active counts */
} af2_ctx;

static void apply2_frames_leaf_range(af2_ctx *x, int64_t i, int64_t w0,
                                     int64_t w1, double *pa, double *ps,
                                     double *pb) {
  int m = x->am[i];
  if (m == 0) {
    copy_partials_range(x->vin + x->off[i], x->vout + x->off[i], x->ns[i],
                        x->padded[i], w0 * 32, w1 * 32, pa, ps, pb);
    return;
  }
  apply2_frames_range(x->vin + x->off[i], x->vout + x->off[i],
                      x->sps + (size_t)i * x->k, x->mps + (size_t)i * x->k,
                      x->svals + (size_t)i * x->k, m, x->ns[i], x->padded[i],
                      w0, w1, pa, ps, pb);
}

#ifdef ST_POOL
static void apply2_frames_seg(void *vctx, int64_t c) {
  af2_ctx *x = (af2_ctx *)vctx;
  const stc_chunk *ch = &x->chunks[c];
  apply2_frames_leaf_range(x, ch->leaf, ch->w0, ch->w1,
                           x->camax ? &x->camax[c] : NULL,
                           x->camax ? &x->css[c] : NULL,
                           x->camax ? &x->csabs[c] : NULL);
}
#endif

/* shared tail (see apply_frames_run) */
static void apply2_frames_run(af2_ctx *x, int64_t n_leaves,
                              const int64_t *padded, double *out_amax,
                              double *out_ss, double *out_sabs) {
#ifdef ST_POOL
  int64_t total = 0;
  int64_t nc = stc_count_chunks(padded, n_leaves, &total);
  if (total >= ST_PAR_MIN_ELEMS) {
    stc_chunk *chunks = (stc_chunk *)malloc((size_t)nc * sizeof(stc_chunk));
    double *pbuf =
        out_amax ? (double *)malloc((size_t)nc * 3 * sizeof(double)) : NULL;
    if (chunks && (!out_amax || pbuf)) {
      stc_build_chunks(padded, n_leaves, chunks);
      x->chunks = chunks;
      x->camax = pbuf;
      x->css = pbuf ? pbuf + nc : NULL;
      x->csabs = pbuf ? pbuf + 2 * nc : NULL;
      if (stc_pool_run(apply2_frames_seg, x, nc)) {
        if (out_amax)
          reduce_chunk_partials(chunks, nc, n_leaves, x->camax, x->css,
                                x->csabs, out_amax, out_ss, out_sabs);
        free(chunks);
        free(pbuf);
        return;
      }
      x->camax = NULL;
      x->css = NULL;
      x->csabs = NULL;
    }
    free(chunks);
    free(pbuf);
  }
#endif
  for (int64_t i = 0; i < n_leaves; i++) {
    apply2_frames_leaf_range(x, i, 0, padded[i] / 32,
                             out_amax ? &out_amax[i] : NULL,
                             out_amax ? &out_ss[i] : NULL,
                             out_amax ? &out_sabs[i] : NULL);
  }
}

/* Fused k-frame sign2 apply (stc_apply_frames's 2-bit twin). words is
 * k * 2W: frame f's sign plane at f*2W, its magnitude plane at f*2W + W —
 * exactly the order the planes arrive inside a wire frame body. */
EXPORT void stc_apply_frames2(const float *vin, float *vout,
                              const int64_t *off, const int64_t *ns,
                              const int64_t *padded, int64_t n_leaves,
                              int64_t W, int32_t k,
                              const float *scales /* k*L */,
                              const uint32_t *words /* k*2W */,
                              double *out_amax, double *out_ss,
                              double *out_sabs) {
  if (k <= 0) return;
  const uint32_t **sps =
      (const uint32_t **)malloc((size_t)n_leaves * k * 2 * sizeof(uint32_t *));
  float *svals = (float *)malloc((size_t)n_leaves * k * sizeof(float));
  int32_t *am = (int32_t *)malloc((size_t)n_leaves * sizeof(int32_t));
  if (!sps || !svals || !am) {
    free(sps);
    free(svals);
    free(am);
    return; /* OOM on tiny metadata arrays: nothing sane left to do */
  }
  const uint32_t **mps = sps + (size_t)n_leaves * k;
  for (int64_t i = 0; i < n_leaves; i++) {
    int32_t m = 0;
    for (int32_t f = 0; f < k; f++) {
      float s = scales[(size_t)f * n_leaves + i];
      if (s == 0.0f) continue;
      sps[(size_t)i * k + m] = words + (size_t)f * 2 * W + off[i] / 32;
      mps[(size_t)i * k + m] = words + (size_t)f * 2 * W + W + off[i] / 32;
      svals[(size_t)i * k + m] = s;
      m++;
    }
    am[i] = m;
  }
  af2_ctx x;
  x.vin = vin;
  x.vout = vout;
  x.off = off;
  x.ns = ns;
  x.padded = padded;
  x.W = W;
  x.k = k;
  x.camax = NULL;
  x.css = NULL;
  x.csabs = NULL;
  x.sps = sps;
  x.mps = mps;
  x.svals = svals;
  x.am = am;
  apply2_frames_run(&x, n_leaves, padded, out_amax, out_ss, out_sabs);
  free(sps);
  free(svals);
  free(am);
}

/* r14: the sign2 twin of stc_apply_frames_wire — per frame f the wire
 * body is [scales L*4][sign W*4][mag W*4] at body + f*stride (4-aligned
 * by the v3 framing). */
EXPORT void stc_apply_frames2_wire(const float *vin, float *vout,
                                   const int64_t *off, const int64_t *ns,
                                   const int64_t *padded, int64_t n_leaves,
                                   int64_t W, int32_t k, const uint8_t *body,
                                   int64_t stride, double *out_amax,
                                   double *out_ss, double *out_sabs) {
  if (k <= 0) return;
  const uint32_t **sps =
      (const uint32_t **)malloc((size_t)n_leaves * k * 2 * sizeof(uint32_t *));
  float *svals = (float *)malloc((size_t)n_leaves * k * sizeof(float));
  int32_t *am = (int32_t *)malloc((size_t)n_leaves * sizeof(int32_t));
  if (!sps || !svals || !am) {
    free(sps);
    free(svals);
    free(am);
    return; /* OOM on tiny metadata arrays: nothing sane left to do */
  }
  const uint32_t **mps = sps + (size_t)n_leaves * k;
  for (int64_t i = 0; i < n_leaves; i++) {
    int32_t m = 0;
    for (int32_t f = 0; f < k; f++) {
      const uint8_t *fb = body + (size_t)f * stride;
      float s = ((const float *)fb)[i];
      if (s == 0.0f) continue;
      const uint32_t *w = (const uint32_t *)(fb + 4 * n_leaves);
      sps[(size_t)i * k + m] = w + off[i] / 32;
      mps[(size_t)i * k + m] = w + W + off[i] / 32;
      svals[(size_t)i * k + m] = s;
      m++;
    }
    am[i] = m;
  }
  af2_ctx x;
  x.vin = vin;
  x.vout = vout;
  x.off = off;
  x.ns = ns;
  x.padded = padded;
  x.W = W;
  x.k = k;
  x.camax = NULL;
  x.css = NULL;
  x.csabs = NULL;
  x.sps = sps;
  x.mps = mps;
  x.svals = svals;
  x.am = am;
  apply2_frames_run(&x, n_leaves, padded, out_amax, out_ss, out_sabs);
  free(sps);
  free(svals);
  free(am);
}

/* Single sign2 frame applied in place (the engine's rollback path: re-
 * applying a ledgered sign2 frame to the residual restores the
 * pre-quantize state, the 1-bit _unapply discipline). words = [sign W |
 * mag W], the frame's wire body layout. */
EXPORT void stc_apply_frame2(const float *vin, float *vout,
                             const int64_t *off, const int64_t *ns,
                             const int64_t *padded, int64_t n_leaves,
                             int64_t W, const float *scales,
                             const uint32_t *words) {
  stc_apply_frames2(vin, vout, off, ns, padded, n_leaves, W, 1, scales, words,
                    NULL, NULL, NULL);
}
