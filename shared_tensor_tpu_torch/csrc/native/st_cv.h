// st_cv.h: condition-variable deadline waits pinned to the SYSTEM clock.
//
// Why this exists (r13 TSan arm): with glibc >= 2.30, libstdc++ implements
// steady-clock condvar waits — condition_variable::wait_for and
// wait_until(steady_clock::time_point) — via pthread_cond_clockwait, which
// this image's libtsan (gcc 10) does NOT intercept. The wait's internal
// unlock/relock is then invisible to ThreadSanitizer: its lock state
// corrupts and every later operation on that mutex yields bogus
// "double lock of a mutex" / data-race reports (reproduced in isolation;
// this is why the pre-r13 native/tsan build was abandoned as unusable).
// System-clock deadlines go through the intercepted pthread_cond_timedwait
// on every toolchain.
//
// Cost of the pin: a wall-clock step (NTP) during a wait stretches or
// shortens THAT wait by at most its own bound. Every wait in the native
// tier is a bounded tick inside a re-check loop (2 ms .. 1 s), so a step
// costs one tick of latency, never a missed wakeup — the same contract
// the codec pool's CLOCK_REALTIME pthread_cond_timedwait has always had.
//
// Use st_cv_deadline(sec) once per logical wait and loop on
// cv.wait_until(lk, deadline): the total timeout spans spurious wakeups,
// exactly like the wait_for(pred) form it replaces.

#ifndef ST_CV_H_
#define ST_CV_H_

#include <chrono>

using StCvClock = std::chrono::system_clock;

inline StCvClock::time_point st_cv_deadline(double sec) {
  return StCvClock::now() + std::chrono::duration_cast<StCvClock::duration>(
                                std::chrono::duration<double>(sec));
}

#endif  // ST_CV_H_
