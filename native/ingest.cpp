// Native host ingest runtime for gnss_sdr.
//
// Equivalent of the reference's native layer: librtlsdr /
// libSoapySDR FFI + reader thread + SPSC ring
// (reference: src/rtlsdr_wrapper.rs, src/sdr_store/sdr_thread.rs:9-37,
// src/rf/samples_buffer.rs). Accelerators cannot talk USB, so the native layer's
// job here is the host-side data plane: wire-format conversion
// (int8 real / interleaved IQ -> planar f32), a lock-free single
// producer / single-consumer byte ring, and a background file/FIFO
// reader thread that keeps the ring full while the Python host ships
// blocks to the device. Exposed via a plain C ABI for ctypes.
//
// Build: make -C native   (g++ -O3 -march=native, no deps)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// wire-format conversion (the reference does this per 16-float SIMD
// chunk in Rust, frontend.rs:34-40; here auto-vectorized by -O3)
// ---------------------------------------------------------------------------

void convert_int8_real(const int8_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = (float)in[i];
        im[i] = 0.0f;
    }
}

void convert_int8_iq(const int8_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = (float)in[2 * i];
        im[i] = (float)in[2 * i + 1];
    }
}

// RTL-SDR style unsigned bytes centered at 127.5
void convert_uint8_iq(const uint8_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = (float)in[2 * i] - 127.5f;
        im[i] = (float)in[2 * i + 1] - 127.5f;
    }
}

void convert_int16_iq(const int16_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = (float)in[2 * i];
        im[i] = (float)in[2 * i + 1];
    }
}

// ---------------------------------------------------------------------------
// SPSC byte ring (the reference's ringbuf::HeapRb role,
// samples_buffer.rs:14-18), power-of-two capacity, absolute indices —
// the same monotone-index design as the multicast ring
// (multicast_ring_buffer.rs:36-43) but single-consumer.
// ---------------------------------------------------------------------------

struct Ring {
    uint8_t* buf;
    size_t mask;
    std::atomic<uint64_t> head;  // written by producer
    std::atomic<uint64_t> tail;  // written by consumer
    std::atomic<int> eos;
};

void* ring_create(size_t capacity_pow2) {
    size_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    Ring* r = new Ring();
    r->buf = (uint8_t*)malloc(cap);
    r->mask = cap - 1;
    r->head.store(0);
    r->tail.store(0);
    r->eos.store(0);
    return r;
}

void ring_destroy(void* rp) {
    Ring* r = (Ring*)rp;
    free(r->buf);
    delete r;
}

size_t ring_capacity(void* rp) { return ((Ring*)rp)->mask + 1; }

size_t ring_available(void* rp) {
    Ring* r = (Ring*)rp;
    return (size_t)(r->head.load(std::memory_order_acquire) -
                    r->tail.load(std::memory_order_acquire));
}

int ring_eos(void* rp) { return ((Ring*)rp)->eos.load(); }
void ring_set_eos(void* rp) { ((Ring*)rp)->eos.store(1); }

// producer: push up to n bytes, returns bytes accepted
size_t ring_push(void* rp, const uint8_t* data, size_t n) {
    Ring* r = (Ring*)rp;
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t free_space = (r->mask + 1) - (size_t)(head - tail);
    if (n > free_space) n = free_space;
    for (size_t i = 0; i < n; ++i)
        r->buf[(head + i) & r->mask] = data[i];
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// consumer: pop up to n bytes, returns bytes delivered
size_t ring_pop(void* rp, uint8_t* out, size_t n) {
    Ring* r = (Ring*)rp;
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = (size_t)(head - tail);
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i)
        out[i] = r->buf[(tail + i) & r->mask];
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// background reader thread (the reference's sdr_thread: device -> ring
// with backoff, sdr_thread.rs:23-33)
// ---------------------------------------------------------------------------

struct Reader {
    FILE* f;
    Ring* ring;
    std::thread th;
    std::atomic<int> stop;
    size_t chunk;
};

static void reader_loop(Reader* rd) {
    uint8_t* tmp = (uint8_t*)malloc(rd->chunk);
    while (!rd->stop.load()) {
        size_t got = fread(tmp, 1, rd->chunk, rd->f);
        if (got == 0) {
            rd->ring->eos.store(1);
            break;
        }
        size_t off = 0;
        while (off < got && !rd->stop.load()) {
            size_t pushed = ring_push(rd->ring, tmp + off, got - off);
            off += pushed;
            if (pushed == 0)
                std::this_thread::sleep_for(std::chrono::milliseconds(2));
        }
    }
    free(tmp);
}

void* reader_start(const char* path, void* ring, size_t chunk) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    Reader* rd = new Reader();
    rd->f = f;
    rd->ring = (Ring*)ring;
    rd->stop.store(0);
    rd->chunk = chunk ? chunk : 262144;
    rd->th = std::thread(reader_loop, rd);
    return rd;
}

void reader_stop(void* rdp) {
    Reader* rd = (Reader*)rdp;
    rd->stop.store(1);
    if (rd->th.joinable()) rd->th.join();
    fclose(rd->f);
    delete rd;
}

}  // extern "C"
