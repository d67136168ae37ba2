// rtdd_runtime — native host runtime for the TPU depth-diffusion framework.
//
// The reference implements its host layer in C++ inside main.cpp (pyramid
// geometry src/main.cpp:92-113, brush + event handling :46-62, annotation
// codec :160-170, buffer management :115-149). This library re-provides that
// layer as a reusable native runtime driving the JAX/TPU compute path:
//
//   * plan        — pyramid level sizes + per-level iteration schedule
//   * paint       — square-brush rasterization into host annotation planes,
//                   with dirty-rect tracking for incremental device updates
//   * annotation  — sentinel-32 byte-plane codec (checkpoint format)
//   * event queue — fixed-capacity MPSC ring buffer decoupling the UI thread
//                   from the solve loop
//   * arena       — bump allocator for per-session host frame buffers
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Pyramid + schedule planner (src/main.cpp:95,103,263 semantics)
// ---------------------------------------------------------------------------

// Returns the number of levels; fills rows[i], cols[i], iters[i] for each
// level (arrays must hold at least max_levels entries).
int rtdd_plan(int rows, int cols, int base_size, int max_iterations,
              int* level_rows, int* level_cols, int* level_iters,
              int max_levels) {
    if (rows <= 0 || cols <= 0 || base_size <= 0) return 0;
    int q = std::max(std::min(rows, cols) / base_size, 1);
    int levels = (int)std::log2((double)q) + 1;
    if (levels > max_levels) levels = max_levels;
    for (int l = 0; l < levels; ++l) {
        level_rows[l] = rows >> l;
        level_cols[l] = cols >> l;
        level_iters[l] =
            (int)(max_iterations / std::pow(2.0, (double)(levels - 1 - l)));
    }
    return levels;
}

/// Chebyshev omega schedule (src/GPUSolver.cu:295-299 semantics: float
// storage; `rho * rho * omega` is a float chain, only the subtraction
// against the 2.0/4.0 double literals promotes).
void rtdd_chebyshev_omegas(int iters, int s, float rho, float* out) {
    float omega = 0.0f;
    float rho2 = rho * rho;
    for (int i = 0; i < iters; ++i) {
        if (i < s) omega = 1.0f;
        else if (i == s) omega = (float)(2.0 / (2.0 - (double)rho2));
        else omega = (float)(4.0 / (4.0 - (double)(rho2 * omega)));
        out[i] = omega;
    }
}

// ---------------------------------------------------------------------------
// Brush rasterizer with dirty-rect (square brush, |px-x| <= radius/2)
// ---------------------------------------------------------------------------

// Paints into mask (0/1) and value planes; writes the clipped dirty rect
// into rect[4] = {y0, x0, y1, x1} (inclusive) and returns 1 if anything was
// painted, 0 otherwise.
int rtdd_paint(uint8_t* mask, uint8_t* value, int rows, int cols,
               int x, int y, int color, int radius, int* rect) {
    int half = std::max(radius, 0) / 2;
    int y0 = std::max(y - half, 0), y1 = std::min(y + half, rows - 1);
    int x0 = std::max(x - half, 0), x1 = std::min(x + half, cols - 1);
    if (y0 > y1 || x0 > x1) return 0;
    for (int py = y0; py <= y1; ++py) {
        std::memset(mask + (size_t)py * cols + x0, 1, (size_t)(x1 - x0 + 1));
        std::memset(value + (size_t)py * cols + x0, (uint8_t)color,
                    (size_t)(x1 - x0 + 1));
    }
    rect[0] = y0; rect[1] = x0; rect[2] = y1; rect[3] = x1;
    return 1;
}

// ---------------------------------------------------------------------------
// Annotation codec (sentinel semantics of src/main.cpp:160-170 / :297-318)
// ---------------------------------------------------------------------------

// png_plane -> (mask, value): every byte != sentinel is annotated.
void rtdd_annotation_decode(const uint8_t* plane, int n, uint8_t sentinel,
                            uint8_t* mask, uint8_t* value) {
    for (int i = 0; i < n; ++i) {
        uint8_t v = plane[i];
        uint8_t m = (uint8_t)(v != sentinel);
        mask[i] = m;
        value[i] = m ? v : 0;
    }
}

// (mask, value) -> png_plane with sentinel at unannotated pixels.
void rtdd_annotation_encode(const uint8_t* mask, const uint8_t* value, int n,
                            uint8_t sentinel, uint8_t* plane) {
    for (int i = 0; i < n; ++i) plane[i] = mask[i] ? value[i] : sentinel;
}

// ---------------------------------------------------------------------------
// Event queue: fixed-capacity MPSC ring (UI thread -> solve loop)
// ---------------------------------------------------------------------------

struct RtddEvent {
    int32_t kind;  // 0 = paint, 1 = key, 2 = solve-request, 3 = quit
    int32_t a;     // x / keycode
    int32_t b;     // y
    int32_t c;     // color / modifier
};

struct RtddQueue {
    RtddEvent* buf;
    uint32_t capacity;           // power of two
    std::atomic<uint32_t> head;  // producer cursor (ticket)
    std::atomic<uint32_t> tail;  // consumer cursor
    std::atomic<uint32_t>* ready;
};

void* rtdd_queue_create(uint32_t capacity_pow2) {
    uint32_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    RtddQueue* q = new RtddQueue();
    q->buf = new RtddEvent[cap];
    q->ready = new std::atomic<uint32_t>[cap];
    for (uint32_t i = 0; i < cap; ++i) q->ready[i].store(0);
    q->capacity = cap;
    q->head.store(0);
    q->tail.store(0);
    return q;
}

void rtdd_queue_destroy(void* qp) {
    RtddQueue* q = (RtddQueue*)qp;
    delete[] q->buf;
    delete[] q->ready;
    delete q;
}

// Returns 1 on success, 0 if the queue is full (event dropped — UI events
// are coalescable so dropping under pressure is the right policy).
int rtdd_queue_push(void* qp, int kind, int a, int b, int c) {
    RtddQueue* q = (RtddQueue*)qp;
    uint32_t head = q->head.load(std::memory_order_relaxed);
    for (;;) {
        if (head - q->tail.load(std::memory_order_acquire) >= q->capacity)
            return 0;
        if (q->head.compare_exchange_weak(head, head + 1,
                                          std::memory_order_acq_rel))
            break;
    }
    uint32_t slot = head & (q->capacity - 1);
    q->buf[slot] = RtddEvent{kind, a, b, c};
    q->ready[slot].store(1, std::memory_order_release);
    return 1;
}

// Returns 1 and fills out[4] = {kind, a, b, c} if an event was available.
int rtdd_queue_pop(void* qp, int* out) {
    RtddQueue* q = (RtddQueue*)qp;
    uint32_t tail = q->tail.load(std::memory_order_relaxed);
    if (tail == q->head.load(std::memory_order_acquire)) return 0;
    uint32_t slot = tail & (q->capacity - 1);
    if (!q->ready[slot].load(std::memory_order_acquire)) return 0;
    RtddEvent e = q->buf[slot];
    q->ready[slot].store(0, std::memory_order_release);
    q->tail.store(tail + 1, std::memory_order_release);
    out[0] = e.kind; out[1] = e.a; out[2] = e.b; out[3] = e.c;
    return 1;
}

int rtdd_queue_size(void* qp) {
    RtddQueue* q = (RtddQueue*)qp;
    return (int)(q->head.load() - q->tail.load());
}

// ---------------------------------------------------------------------------
// Arena allocator for host frame buffers (C11's host analog)
// ---------------------------------------------------------------------------

struct RtddArena {
    uint8_t* base;
    size_t capacity;
    size_t offset;
};

void* rtdd_arena_create(size_t bytes) {
    RtddArena* a = new RtddArena();
    // 64-aligned base so per-allocation alignment (offset rounding in
    // rtdd_arena_alloc) holds in absolute addresses, not just offsets.
    size_t rounded = (bytes + 63) & ~(size_t)63;
    a->base = (uint8_t*)std::aligned_alloc(64, rounded);
    a->capacity = a->base ? rounded : 0;
    a->offset = 0;
    return a;
}

void* rtdd_arena_alloc(void* ap, size_t bytes, size_t align) {
    RtddArena* a = (RtddArena*)ap;
    if (align == 0) align = 64;
    size_t off = (a->offset + align - 1) & ~(align - 1);
    if (off + bytes > a->capacity) return nullptr;
    a->offset = off + bytes;
    return a->base + off;
}

void rtdd_arena_reset(void* ap) { ((RtddArena*)ap)->offset = 0; }

size_t rtdd_arena_used(void* ap) { return ((RtddArena*)ap)->offset; }

void rtdd_arena_destroy(void* ap) {
    RtddArena* a = (RtddArena*)ap;
    std::free(a->base);
    delete a;
}

int rtdd_version() { return 1; }

}  // extern "C"
