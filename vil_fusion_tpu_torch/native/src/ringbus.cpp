// Lock-free SPSC ring-buffer message bus — the native transport layer.
//
// Rebuild of the reference's inter-stage communication (SURVEY §2.3): ROS
// TCPROS pub/sub with mutex-guarded std::queues (estimator_node.cpp m_buf,
// poseGraphOptimization.cpp buf_mutex) becomes an in-process bus of
// fixed-capacity single-producer/single-consumer rings with C11 atomics —
// no locks on the hot path, explicit drop-oldest backpressure exactly like
// the reference's bounded queue depths (100-2000).
//
// Slot integrity under drop-oldest: when the ring is full the producer
// reclaims the consumer's slot, so each slot carries a seqlock (per-write
// sequence). The consumer validates the sequence before AND after its copy;
// a mismatch means the slot was reclaimed mid-read — the message counts as
// dropped and the consumer retries at the advanced tail.
//
// C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>

extern "C" {

struct Slot {
    std::atomic<uint64_t> seq;  // 2*index+2 when stable, odd while writing
    double timestamp;
    uint32_t size;  // bytes used
};

struct Topic {
    char name[64];
    uint32_t slot_bytes;   // payload capacity per slot
    uint32_t capacity;     // number of slots (power of two)
    std::atomic<uint64_t> head;  // next write index (producer)
    std::atomic<uint64_t> tail;  // next read index (consumer)
    std::atomic<uint64_t> dropped;
    uint8_t* data;         // capacity * (sizeof(Slot) + slot_bytes)
};

static inline Slot* slot_at(Topic* t, uint64_t idx) {
    uint64_t stride = sizeof(Slot) + t->slot_bytes;
    return reinterpret_cast<Slot*>(t->data + (idx & (t->capacity - 1)) * stride);
}

Topic* topic_create(const char* name, uint32_t slot_bytes, uint32_t capacity) {
    uint32_t cap = 1;
    while (cap < capacity) cap <<= 1;
    Topic* t = new (std::nothrow) Topic();
    if (!t) return nullptr;
    std::strncpy(t->name, name, sizeof(t->name) - 1);
    t->name[sizeof(t->name) - 1] = 0;
    t->slot_bytes = slot_bytes;
    t->capacity = cap;
    t->head.store(0, std::memory_order_relaxed);
    t->tail.store(0, std::memory_order_relaxed);
    t->dropped.store(0, std::memory_order_relaxed);
    uint64_t stride = sizeof(Slot) + slot_bytes;
    t->data = static_cast<uint8_t*>(std::calloc(cap, stride));
    if (!t->data) { delete t; return nullptr; }
    for (uint32_t i = 0; i < cap; ++i) {
        new (&slot_at(t, i)->seq) std::atomic<uint64_t>(0);
    }
    return t;
}

void topic_destroy(Topic* t) {
    if (!t) return;
    std::free(t->data);
    delete t;
}

// Producer side. Returns 1 on success, 0 if payload too large.
// When full, drops the oldest message (bounded-queue semantics).
int topic_publish(Topic* t, double timestamp, const void* payload, uint32_t size) {
    if (size > t->slot_bytes) return 0;
    uint64_t head = t->head.load(std::memory_order_relaxed);
    uint64_t tail = t->tail.load(std::memory_order_acquire);
    if (head - tail >= t->capacity) {
        // drop oldest: advance tail; the seqlock protects the consumer if it
        // is mid-copy in the reclaimed slot
        t->tail.compare_exchange_strong(tail, tail + 1, std::memory_order_acq_rel);
        t->dropped.fetch_add(1, std::memory_order_relaxed);
    }
    Slot* s = slot_at(t, head);
    s->seq.store(2 * head + 1, std::memory_order_release);  // writing
    s->timestamp = timestamp;
    s->size = size;
    std::memcpy(reinterpret_cast<uint8_t*>(s) + sizeof(Slot), payload, size);
    s->seq.store(2 * head + 2, std::memory_order_release);  // stable
    t->head.store(head + 1, std::memory_order_release);
    return 1;
}

// Consumer side. Returns payload size (>0), 0 if empty, -1 if out_cap too small.
int topic_poll(Topic* t, double* timestamp, void* out, uint32_t out_cap) {
    for (int attempt = 0; attempt < 16; ++attempt) {
        uint64_t tail = t->tail.load(std::memory_order_relaxed);
        uint64_t head = t->head.load(std::memory_order_acquire);
        if (tail >= head) return 0;
        Slot* s = slot_at(t, tail);
        uint64_t seq0 = s->seq.load(std::memory_order_acquire);
        double ts = s->timestamp;
        uint32_t size = s->size;
        if (seq0 == 2 * tail + 2 && size <= out_cap) {
            std::memcpy(out, reinterpret_cast<uint8_t*>(s) + sizeof(Slot), size);
            std::atomic_thread_fence(std::memory_order_acquire);
            uint64_t seq1 = s->seq.load(std::memory_order_acquire);
            if (seq1 == seq0) {
                // copy is clean iff the slot was not reclaimed; claim it
                if (t->tail.compare_exchange_strong(
                        tail, tail + 1, std::memory_order_acq_rel)) {
                    *timestamp = ts;
                    return static_cast<int>(size);
                }
                continue;  // producer dropped this slot first; retry at new tail
            }
        } else if (seq0 == 2 * tail + 2) {
            return -1;  // valid message but caller's buffer too small
        }
        // torn or reclaimed slot: skip it if still ours, then retry
        t->tail.compare_exchange_strong(tail, tail + 1, std::memory_order_acq_rel);
    }
    return 0;
}

uint64_t topic_pending(Topic* t) {
    return t->head.load(std::memory_order_acquire) -
           t->tail.load(std::memory_order_acquire);
}

uint64_t topic_dropped(Topic* t) {
    return t->dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
