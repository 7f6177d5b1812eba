// Native runtime tier: paged-KV page allocator + continuous-batching
// scheduler (C ABI, loaded via ctypes).
//
// Role mapping vs the reference repo: the reference's native tier is the
// CUDA kernel + its C++ binding (reference: csrc/flash_attention_api.cpp);
// on TPU the kernel tier is Pallas (compiled by XLA), so the native tier
// here is the piece that genuinely runs on the host CPU in the serving
// loop: page bookkeeping and request scheduling, where per-step Python
// overhead would otherwise sit on the decode critical path.
//
// Semantics mirror runtime/paged_cache.py::PageAllocator exactly (page 0
// reserved as the null page; LIFO free list for locality) — the Python
// class remains as the portable fallback and as executable documentation,
// and tests/test_native_runtime.py checks the two stay in lockstep.
//
// Build: see runtime/native.py (g++ -O2 -shared -fPIC, cached .so; the
// analog of the reference's import-time JIT extension build,
// reference: flash_attention/load_cpp_extention.py:23-53).

#include <algorithm>
#include <cstdint>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct Allocator {
  int page_size;
  int pages_per_seq;
  std::vector<int32_t> free_pages;  // LIFO
  std::unordered_map<int64_t, std::vector<int32_t>> tables;
  // Reference counts (prefix caching): a page is owned by every sequence
  // table referencing it PLUS one count per cache pin. The free list
  // holds exactly the pages with refcount 0. Mirrors
  // runtime/paged_cache.py::PageAllocator (lockstep property test).
  std::unordered_map<int32_t, int32_t> refs;

  Allocator(int num_pages, int ps, int pps)
      : page_size(ps), pages_per_seq(pps) {
    free_pages.reserve(num_pages > 0 ? num_pages - 1 : 0);
    // Match the Python free-list order: list(range(num_pages-1, 0, -1))
    // popped from the back => pages handed out 1, 2, 3, ...
    for (int p = 1; p < num_pages; ++p) free_pages.push_back(p);
    // push_back(1..n-1) then pop_back would hand out n-1 first; reverse to
    // hand out ascending like the Python version.
    std::reverse(free_pages.begin(), free_pages.end());
  }

  static int ceil_div(int a, int b) { return (a + b - 1) / b; }

  int pages_needed(int cur_len, int new_tokens) const {
    int have = cur_len ? ceil_div(cur_len, page_size) : 0;
    int need = ceil_div(cur_len + new_tokens, page_size);
    return need > have ? need - have : 0;
  }

  bool allocate(int64_t seq_id, int cur_len, int new_tokens) {
    int n = pages_needed(cur_len, new_tokens);
    if (n > static_cast<int>(free_pages.size())) return false;
    auto& tbl = tables[seq_id];
    if (static_cast<int>(tbl.size()) + n > pages_per_seq) return false;
    for (int i = 0; i < n; ++i) {
      int32_t p = free_pages.back();
      free_pages.pop_back();
      refs[p] = 1;
      tbl.push_back(p);
    }
    return true;
  }

  // Append already-live pages (a cached prompt prefix) to seq_id's table,
  // taking a reference on each; free pages cannot be shared.
  bool share(int64_t seq_id, const int32_t* pages, int n) {
    auto& tbl = tables[seq_id];
    if (static_cast<int>(tbl.size()) + n > pages_per_seq) return false;
    for (int i = 0; i < n; ++i) {
      auto it = refs.find(pages[i]);
      if (it == refs.end() || it->second <= 0) return false;
    }
    for (int i = 0; i < n; ++i) {
      refs[pages[i]] += 1;
      tbl.push_back(pages[i]);
    }
    return true;
  }

  // Pop a free page and hand it out PINNED (refcount 1, in no sequence
  // table): the prefix cache's host-swap restore path uploads KV into it
  // and owns it via the cache pin until eviction. -1 when empty.
  int32_t take_free_page() {
    if (free_pages.empty()) return -1;
    int32_t p = free_pages.back();
    free_pages.pop_back();
    refs[p] = 1;
    return p;
  }

  bool pin(int32_t page) {
    auto it = refs.find(page);
    if (it == refs.end() || it->second <= 0) return false;
    it->second += 1;
    return true;
  }

  void unpin(int32_t page) {
    int32_t r = refs[page] - 1;
    refs[page] = r;
    if (r == 0) free_pages.push_back(page);
  }

  int refcount(int32_t page) const {
    auto it = refs.find(page);
    return it == refs.end() ? 0 : it->second;
  }

  void release(int64_t seq_id) {
    auto it = tables.find(seq_id);
    if (it == tables.end()) return;
    // Python extends with reversed(tbl), refcount-0 pages only; match it.
    for (auto rit = it->second.rbegin(); rit != it->second.rend(); ++rit) {
      int32_t r = refs[*rit] - 1;
      refs[*rit] = r;
      if (r == 0) free_pages.push_back(*rit);
    }
    tables.erase(it);
  }
};

// FCFS continuous-batching scheduler with decode-OOM preemption: requests
// wait in arrival order; a request is admitted when a batch slot AND its
// prefill pages are available; on decode-time page exhaustion the YOUNGEST
// running request is preempted back to the wait queue (classic vLLM-style
// policy, re-implemented from scratch).
struct Scheduler {
  struct Request {
    int64_t id;
    int prompt_len;
    int max_new_tokens;
    int generated = 0;
    int priority = 0;   // higher admits sooner, preempts later
    int64_t seq = 0;    // arrival order (FIFO within a priority)
  };

  Allocator alloc;
  int max_slots;
  int64_t next_seq = 0;
  std::deque<Request> waiting;
  // Prefix-cache grants: rid -> cached prefix pages to share at
  // admission. Advisory and consumed per admission attempt — the engine
  // re-grants from the live cache before every admit().
  std::unordered_map<int64_t, std::vector<int32_t>> grants;
  std::vector<Request> running;   // index == batch slot, id -1 = empty slot
  std::vector<int64_t> slot_ids;  // -1 = free
  // Anti-livelock gate: while a running request is page-starved, admission
  // is paused so freed (preempted) pages reach the starving request rather
  // than being re-grabbed by the re-queued victim. Cleared on the next
  // successful decode-step allocation.
  bool stalled = false;

  Scheduler(int num_pages, int page_size, int pages_per_seq, int slots)
      : alloc(num_pages, page_size, pages_per_seq),
        max_slots(slots),
        slot_ids(slots, -1) {
    running.resize(slots);
    for (auto& r : running) r.id = -1;
  }

  void submit(int64_t id, int prompt_len, int max_new_tokens,
              int priority = 0) {
    waiting.push_back(
        Request{id, prompt_len, max_new_tokens, 0, priority, next_seq++});
  }

  // Index of the next waiting request: highest priority, then FIFO.
  int next_waiting() const {
    int best = -1;
    for (int i = 0; i < static_cast<int>(waiting.size()); ++i) {
      if (best == -1 ||
          waiting[i].priority > waiting[best].priority ||
          (waiting[i].priority == waiting[best].priority &&
           waiting[i].seq < waiting[best].seq)) {
        best = i;
      }
    }
    return best;
  }

  // Admit as many waiting requests as fit. Returns number admitted;
  // admitted slot indices + ids retrievable via slot_ids.
  int admit() {
    if (stalled) return 0;
    int n = 0;
    for (int s = 0; s < max_slots && !waiting.empty(); ++s) {
      if (slot_ids[s] != -1) continue;
      int widx = next_waiting();
      Request r = waiting[widx];
      std::vector<int32_t> pages;
      auto git = grants.find(r.id);
      if (git != grants.end()) {
        pages = std::move(git->second);
        grants.erase(git);
      }
      int granted = static_cast<int>(pages.size()) * alloc.page_size;
      if (!pages.empty() &&
          !alloc.share(r.id, pages.data(),
                       static_cast<int>(pages.size()))) {
        alloc.release(r.id);
        break;  // in-order: no skip past a starved request
      }
      if (!alloc.allocate(r.id, granted, r.prompt_len - granted)) {
        alloc.release(r.id);  // undo the shared prefix
        break;
      }
      waiting.erase(waiting.begin() + widx);
      slot_ids[s] = r.id;
      running[s] = r;
      ++n;
    }
    return n;
  }

  void grant_prefix(int64_t id, const int32_t* pages, int n) {
    grants[id] = std::vector<int32_t>(pages, pages + n);
  }

  // One decode step for slot s: reserve room for 1 token. Returns:
  //  1 ok, 0 needs-preemption (no pages), -1 slot empty.
  int step_slot(int s) {
    if (slot_ids[s] == -1) return -1;
    Request& r = running[s];
    if (!alloc.allocate(r.id, r.prompt_len + r.generated, 1)) {
      stalled = true;
      return 0;
    }
    stalled = false;
    r.generated += 1;
    return 1;
  }

  int num_running() const {
    int n = 0;
    for (auto id : slot_ids) n += (id != -1);
    return n;
  }

  bool finished(int s) const {
    return slot_ids[s] != -1 &&
           running[s].generated >= running[s].max_new_tokens;
  }

  void release_slot(int s, bool requeue) {
    if (slot_ids[s] == -1) return;
    Request r = running[s];
    alloc.release(r.id);
    if (requeue) {
      r.generated = 0;  // restart from prefill after preemption
      waiting.push_front(r);
    } else {
      // A finish/fail returns pages for good: admission may resume.
      stalled = false;
    }
    slot_ids[s] = -1;
    running[s].id = -1;
  }

  // Preempt the LOWEST-priority running request (youngest arrival
  // within a priority; falls back to the classic youngest-slot rule for
  // all-equal priorities). Refuses (-1) when <= 1 request is running:
  // preempting the only — necessarily the starving — request frees
  // nothing useful; the caller must treat the request as unservable at
  // this pool size.
  int preempt_youngest() {
    if (num_running() <= 1) return -1;
    int victim = -1;
    for (int s = max_slots - 1; s >= 0; --s) {
      if (slot_ids[s] == -1) continue;
      if (victim == -1 ||
          running[s].priority < running[victim].priority ||
          (running[s].priority == running[victim].priority &&
           running[s].seq > running[victim].seq)) {
        victim = s;
      }
    }
    if (victim != -1) release_slot(victim, /*requeue=*/true);
    return victim;
  }
};

}  // namespace

extern "C" {

// ---- allocator ----
void* pa_create(int num_pages, int page_size, int pages_per_seq) {
  return new Allocator(num_pages, page_size, pages_per_seq);
}
void pa_destroy(void* h) { delete static_cast<Allocator*>(h); }
int pa_num_free(void* h) {
  return static_cast<int>(static_cast<Allocator*>(h)->free_pages.size());
}
int pa_pages_needed(void* h, int cur_len, int new_tokens) {
  return static_cast<Allocator*>(h)->pages_needed(cur_len, new_tokens);
}
int pa_allocate(void* h, int64_t seq_id, int cur_len, int new_tokens) {
  return static_cast<Allocator*>(h)->allocate(seq_id, cur_len, new_tokens)
             ? 1
             : 0;
}
void pa_release(void* h, int64_t seq_id) {
  static_cast<Allocator*>(h)->release(seq_id);
}
// Fills out[0:cap] with the padded page-table row; returns #pages used.
int pa_table_row(void* h, int64_t seq_id, int32_t* out, int cap) {
  auto* a = static_cast<Allocator*>(h);
  for (int i = 0; i < cap; ++i) out[i] = 0;
  auto it = a->tables.find(seq_id);
  if (it == a->tables.end()) return 0;
  int n = static_cast<int>(it->second.size());
  if (n > cap) n = cap;
  for (int i = 0; i < n; ++i) out[i] = it->second[i];
  return static_cast<int>(it->second.size());
}

// ---- scheduler ----
void* sched_create(int num_pages, int page_size, int pages_per_seq,
                   int slots) {
  return new Scheduler(num_pages, page_size, pages_per_seq, slots);
}
void sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }
void sched_submit(void* h, int64_t id, int prompt_len, int max_new) {
  static_cast<Scheduler*>(h)->submit(id, prompt_len, max_new);
}
void sched_submit_priority(void* h, int64_t id, int prompt_len, int max_new,
                           int priority) {
  static_cast<Scheduler*>(h)->submit(id, prompt_len, max_new, priority);
}
int sched_admit(void* h) { return static_cast<Scheduler*>(h)->admit(); }
int sched_step_slot(void* h, int s) {
  return static_cast<Scheduler*>(h)->step_slot(s);
}
int sched_finished(void* h, int s) {
  return static_cast<Scheduler*>(h)->finished(s) ? 1 : 0;
}
void sched_release_slot(void* h, int s, int requeue) {
  static_cast<Scheduler*>(h)->release_slot(s, requeue != 0);
}
int sched_preempt_youngest(void* h) {
  return static_cast<Scheduler*>(h)->preempt_youngest();
}
int64_t sched_slot_id(void* h, int s) {
  return static_cast<Scheduler*>(h)->slot_ids[s];
}
int sched_slot_generated(void* h, int s) {
  auto* sc = static_cast<Scheduler*>(h);
  return sc->slot_ids[s] == -1 ? -1 : sc->running[s].generated;
}
int sched_num_waiting(void* h) {
  return static_cast<int>(static_cast<Scheduler*>(h)->waiting.size());
}
int sched_table_row(void* h, int64_t seq_id, int32_t* out, int cap) {
  return pa_table_row(&static_cast<Scheduler*>(h)->alloc, seq_id, out, cap);
}
int sched_num_free_pages(void* h) {
  return static_cast<int>(
      static_cast<Scheduler*>(h)->alloc.free_pages.size());
}
void sched_grant_prefix(void* h, int64_t id, const int32_t* pages, int n) {
  static_cast<Scheduler*>(h)->grant_prefix(id, pages, n);
}
int sched_pin_page(void* h, int32_t page) {
  return static_cast<Scheduler*>(h)->alloc.pin(page) ? 1 : 0;
}
void sched_unpin_page(void* h, int32_t page) {
  static_cast<Scheduler*>(h)->alloc.unpin(page);
}
int sched_page_refcount(void* h, int32_t page) {
  return static_cast<Scheduler*>(h)->alloc.refcount(page);
}
int sched_take_free_page(void* h) {
  return static_cast<Scheduler*>(h)->alloc.take_free_page();
}
int pa_share(void* h, int64_t seq_id, const int32_t* pages, int n) {
  return static_cast<Allocator*>(h)->share(seq_id, pages, n) ? 1 : 0;
}
int pa_pin(void* h, int32_t page) {
  return static_cast<Allocator*>(h)->pin(page) ? 1 : 0;
}
void pa_unpin(void* h, int32_t page) {
  static_cast<Allocator*>(h)->unpin(page);
}
int pa_refcount(void* h, int32_t page) {
  return static_cast<Allocator*>(h)->refcount(page);
}
int pa_take_free_page(void* h) {
  return static_cast<Allocator*>(h)->take_free_page();
}

}  // extern "C"
