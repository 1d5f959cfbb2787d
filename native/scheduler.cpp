// Continuous-batching scheduler for the quantizedattention_tpu serving
// engine (C ABI, loaded via ctypes — no pybind11 in this environment).
//
// The reference (selau642/QuantizedAttention) has no serving layer at all;
// this is the native runtime half of the north-star's "continuous batching
// across hosts": the Python engine owns the JAX compute (prefill /
// batched decode steps), while admission, slot allocation and completion
// bookkeeping live here, off the Python hot path.
//
// Policy: FCFS admission with a capacity check (prompt_len + max_new_tokens
// must fit the slot's KV capacity). Prefill is preferred over decode
// whenever a request is waiting and a slot is free, so the decode batch
// stays as full as possible (the standard continuous-batching rule: join
// between decode steps, leave on completion).

#include <cstddef>
#include <cstdint>
#include <deque>
#include <vector>

namespace {

struct Request {
  int32_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
};

struct Slot {
  int32_t request_id = -1;  // -1 == free
  int32_t generated = 0;
  int32_t max_new_tokens = 0;
  int32_t prompt_len = 0;
};

struct Scheduler {
  int32_t n_slots;
  int32_t max_len;
  std::vector<Slot> slots;
  std::deque<Request> waiting;
  int64_t completed = 0;
  int64_t rejected = 0;

  explicit Scheduler(int32_t n, int32_t cap) : n_slots(n), max_len(cap), slots(n) {}

  int free_slot() const {
    for (int i = 0; i < n_slots; ++i)
      if (slots[i].request_id < 0) return i;
    return -1;
  }

  int num_active() const {
    int n = 0;
    for (const auto& s : slots) n += (s.request_id >= 0);
    return n;
  }
};

}  // namespace

extern "C" {

// Action codes returned by qa_sched_next.
enum { QA_IDLE = 0, QA_PREFILL = 1, QA_DECODE = 2 };

void* qa_sched_create(int32_t n_slots, int32_t max_len) {
  if (n_slots <= 0 || max_len <= 0) return nullptr;
  return new Scheduler(n_slots, max_len);
}

void qa_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Enqueue a request. Returns 0 on success, -1 if it can never fit a slot
// (prompt + generation budget exceeds KV capacity) — the caller should
// surface that to the client instead of letting it pend forever.
int32_t qa_sched_submit(void* h, int32_t request_id, int32_t prompt_len,
                        int32_t max_new_tokens) {
  auto* s = static_cast<Scheduler*>(h);
  if (prompt_len <= 0 || max_new_tokens <= 0 ||
      prompt_len + max_new_tokens > s->max_len) {
    s->rejected++;
    return -1;
  }
  s->waiting.push_back({request_id, prompt_len, max_new_tokens});
  return 0;
}

// Decide the engine's next action.
//   QA_PREFILL: *out_req / *out_slot name the admitted request and its slot
//               (the slot is committed to the request as of this call).
//   QA_DECODE : at least one active slot; run one batched decode step.
//   QA_IDLE   : nothing waiting, nothing active.
int32_t qa_sched_next(void* h, int32_t* out_req, int32_t* out_slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (!s->waiting.empty()) {
    int slot = s->free_slot();
    if (slot >= 0) {
      Request r = s->waiting.front();
      s->waiting.pop_front();
      s->slots[slot] = {r.id, 0, r.max_new_tokens, r.prompt_len};
      if (out_req) *out_req = r.id;
      if (out_slot) *out_slot = slot;
      return QA_PREFILL;
    }
  }
  if (s->num_active() > 0) return QA_DECODE;
  return QA_IDLE;
}

// Report one generated token for a slot (the prefill's first token counts).
// Returns 1 if the request just finished (EOS or budget) and the slot was
// freed, else 0; -1 on a free/invalid slot.
int32_t qa_sched_report_token(void* h, int32_t slot, int32_t is_eos) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->n_slots || s->slots[slot].request_id < 0) return -1;
  Slot& sl = s->slots[slot];
  sl.generated++;
  if (is_eos || sl.generated >= sl.max_new_tokens) {
    sl = Slot{};
    s->completed++;
    return 1;
  }
  return 0;
}

// Undo an admission the engine could not serve (e.g. KV page pool
// exhausted): requeue the slot's request at the FRONT of the waiting queue
// and free the slot. Returns 0 on success, -1 if the slot is free/invalid.
int32_t qa_sched_requeue(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->n_slots || s->slots[slot].request_id < 0) return -1;
  Slot& sl = s->slots[slot];
  s->waiting.push_front({sl.request_id, sl.prompt_len, sl.max_new_tokens});
  sl = Slot{};
  return 0;
}

int32_t qa_sched_num_active(void* h) { return static_cast<Scheduler*>(h)->num_active(); }

int32_t qa_sched_num_waiting(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->waiting.size());
}

int64_t qa_sched_num_completed(void* h) { return static_cast<Scheduler*>(h)->completed; }

int64_t qa_sched_num_rejected(void* h) { return static_cast<Scheduler*>(h)->rejected; }

// Request currently owning `slot`, or -1 if the slot is free.
int32_t qa_sched_slot_request(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->n_slots) return -1;
  return s->slots[slot].request_id;
}

// ---------------------------------------------------------------------------
// Page allocator for the paged KV cache (parallel/paged_cache.py).
// Free-list of fixed-size pages; page 0 is reserved as the null page
// (tables point unused slots at 0, and the kernel may DMA it harmlessly).
// ---------------------------------------------------------------------------

namespace {

struct Pager {
  std::vector<int32_t> free_pages;  // LIFO free list
  std::vector<bool> is_free;        // double-free / alias guard
  int32_t n_pages;

  explicit Pager(int32_t n) : is_free(n, true), n_pages(n) {
    free_pages.reserve(n > 0 ? n - 1 : 0);
    for (int32_t p = n - 1; p >= 1; --p) free_pages.push_back(p);  // 0 reserved
    is_free[0] = false;  // the reserved null page is never handed out
  }
};

}  // namespace

void* qa_pager_create(int32_t n_pages) {
  if (n_pages < 2) return nullptr;  // page 0 is reserved
  return new Pager(n_pages);
}

void qa_pager_destroy(void* h) { delete static_cast<Pager*>(h); }

// Allocate `n` pages into out[0..n). Returns n on success; 0 (and allocates
// nothing) if fewer than n pages are free — all-or-nothing, so a request
// never holds a partial page set.
int32_t qa_pager_alloc(void* h, int32_t n, int32_t* out) {
  auto* p = static_cast<Pager*>(h);
  if (n <= 0 || static_cast<size_t>(n) > p->free_pages.size()) return 0;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = p->free_pages.back();
    p->free_pages.pop_back();
    p->is_free[out[i]] = false;
  }
  return n;
}

// Return `n` pages to the pool. Page 0, out-of-range ids, and pages that
// are already free (double-free — would alias one page to two requests on
// the next alloc) are ignored.
void qa_pager_free(void* h, int32_t n, const int32_t* pages) {
  auto* p = static_cast<Pager*>(h);
  for (int32_t i = 0; i < n; ++i) {
    if (pages[i] >= 1 && pages[i] < p->n_pages && !p->is_free[pages[i]]) {
      p->free_pages.push_back(pages[i]);
      p->is_free[pages[i]] = true;
    }
  }
}

int32_t qa_pager_num_free(void* h) {
  return static_cast<int32_t>(static_cast<Pager*>(h)->free_pages.size());
}

}  // extern "C"
