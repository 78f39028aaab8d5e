// st_annotations.h: clang thread-safety annotations for the native tier.
//
// The r11/r12 review rounds each hand-found a real data race in these files
// (the codec-pool seqlock tearing, the plain-int sleepers, the replayed-STTS
// stripe refcount) — human review was the only race detector the native tier
// had. These macros make the lock discipline machine-checked: every
// mutex-protected field carries ST_GUARDED_BY, every
// must-hold-the-lock-to-call function carries ST_REQUIRES, and
// `make -C native analyze` compiles all three files under clang's
// -Wthread-safety -Werror (tests/test_static_analysis.py smoke-runs it when
// clang is present; the tier-1 gcc build sees only no-op macros).
//
// Lock hierarchy (documented here because the annotations force it to be
// written down; ST_ACQUIRED_AFTER encodes the edges clang can check):
//
//   stengine.cpp   Engine::mu  ->  Engine::add_mu          (fold_pending)
//                  Engine::mu  ->  TxPool::mu              (rollback/ACK unref)
//                  Engine::mu  ->  transport queue mutexes (flush_acks / FRESH
//                                  beats send with zero timeout from under mu)
//                  Engine::wmu and Engine::cmu are leaves (nothing is
//                  acquired under them).
//   sttransport.cpp  Node::mu, Node::ev_mu, Node::data_mu, Link::rmu,
//                  Link::fault_mu and the queue/pool mutexes are mutually
//                  unordered leaves — no path acquires one under another
//                  (kill_link takes Link::rmu and Node::mu SEQUENTIALLY,
//                  never nested).
//                  r14 additions, both leaves: stshm::Lane::tx_mu (the
//                  shm ring's single-writer serialization across the
//                  stripe-death promotion window; held across a whole
//                  record write, including its bounded futex waits — the
//                  ring head/tail atomics themselves are cross-process
//                  and carry their ordering in the futex publish
//                  protocol, not in any mutex) and Node::loan_mu (the
//                  recv_zc loan registry; taken sequentially with
//                  Node::mu, never nested). The shm segment's shared
//                  header fields (joined/closed, Ring head/tail/seq
//                  words) are interprocess atomics outside any
//                  capability the analysis can see — their discipline is
//                  documented at stshm::RingCtl and checked by the TSan
//                  shm arm instead.
//   stcodec.c      g_pool.job_mu -> g_pool.mu (submitter wake/completion
//                  sleep); workers take g_pool.mu alone.
//
// C++ callers use StMutex / StLockGuard / StUniqueLock below — thin
// wrappers over std::mutex whose lock/unlock methods carry the acquire/
// release attributes (libstdc++'s std::mutex is not a clang "capability",
// so guarded-by on it would not type-check). C callers (stcodec.c) define
// their own annotated pthread wrapper next to the pool; only the macros
// live here.

#ifndef ST_ANNOTATIONS_H_
#define ST_ANNOTATIONS_H_

#if defined(__clang__) && defined(__has_attribute)
#if __has_attribute(capability)
#define ST_TSA_(x) __attribute__((x))
#endif
#endif
#ifndef ST_TSA_
#define ST_TSA_(x)  // no-op off clang (gcc builds see plain declarations)
#endif

#define ST_CAPABILITY(x) ST_TSA_(capability(x))
#define ST_SCOPED_CAPABILITY ST_TSA_(scoped_lockable)
// In C, clang does not late-parse thread-safety attribute arguments, so
// a struct member cannot reference a sibling mutex member ("use of
// undeclared identifier 'mu'") — which is exactly what stcodec.c's
// g_pool fields need. The C TU keeps the capability/acquire/release
// CONTRACTS (parameter references parse fine); its guarded-by
// discipline is checked by the TSan arm instead.
#if defined(__cplusplus)
#define ST_GUARDED_BY(x) ST_TSA_(guarded_by(x))
#define ST_PT_GUARDED_BY(x) ST_TSA_(pt_guarded_by(x))
#else
#define ST_GUARDED_BY(x)
#define ST_PT_GUARDED_BY(x)
#endif
#define ST_ACQUIRED_BEFORE(...) ST_TSA_(acquired_before(__VA_ARGS__))
#define ST_ACQUIRED_AFTER(...) ST_TSA_(acquired_after(__VA_ARGS__))
#define ST_REQUIRES(...) ST_TSA_(requires_capability(__VA_ARGS__))
#define ST_ACQUIRE(...) ST_TSA_(acquire_capability(__VA_ARGS__))
#define ST_RELEASE(...) ST_TSA_(release_capability(__VA_ARGS__))
#define ST_TRY_ACQUIRE(...) ST_TSA_(try_acquire_capability(__VA_ARGS__))
#define ST_EXCLUDES(...) ST_TSA_(locks_excluded(__VA_ARGS__))
#define ST_RETURN_CAPABILITY(x) ST_TSA_(lock_returned(x))
#define ST_NO_THREAD_SAFETY_ANALYSIS ST_TSA_(no_thread_safety_analysis)

#ifdef __cplusplus

#include <mutex>

// std::mutex with the capability attribute, so fields can be
// ST_GUARDED_BY(mu) and functions ST_REQUIRES(mu). native() exposes the
// underlying std::mutex for condition_variable waits ONLY — a wait
// releases and re-acquires internally, which is invisible to (and fine
// for) the analysis: the capability is held on both sides of the call.
class ST_CAPABILITY("mutex") StMutex {
 public:
  void lock() ST_ACQUIRE() { mu_.lock(); }
  void unlock() ST_RELEASE() { mu_.unlock(); }
  bool try_lock() ST_TRY_ACQUIRE(true) { return mu_.try_lock(); }
  std::mutex& native() { return mu_; }

 private:
  std::mutex mu_;
};

// std::lock_guard twin.
class ST_SCOPED_CAPABILITY StLockGuard {
 public:
  explicit StLockGuard(StMutex& mu) ST_ACQUIRE(mu) : mu_(mu) { mu_.lock(); }
  ~StLockGuard() ST_RELEASE() { mu_.unlock(); }
  StLockGuard(const StLockGuard&) = delete;
  StLockGuard& operator=(const StLockGuard&) = delete;

 private:
  StMutex& mu_;
};

// std::unique_lock twin for the condvar / manual unlock-relock sites.
// Pass native() to condition_variable::wait*; the lock state the condvar
// hands back matches what the analysis assumes (held).
class ST_SCOPED_CAPABILITY StUniqueLock {
 public:
  explicit StUniqueLock(StMutex& mu) ST_ACQUIRE(mu)
      : lk_(mu.native()) {}
  ~StUniqueLock() ST_RELEASE() {}
  void lock() ST_ACQUIRE() { lk_.lock(); }
  void unlock() ST_RELEASE() { lk_.unlock(); }
  std::unique_lock<std::mutex>& native() { return lk_; }
  StUniqueLock(const StUniqueLock&) = delete;
  StUniqueLock& operator=(const StUniqueLock&) = delete;

 private:
  std::unique_lock<std::mutex> lk_;
};

#endif  // __cplusplus
#endif  // ST_ANNOTATIONS_H_
