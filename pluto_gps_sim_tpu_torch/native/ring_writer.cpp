// Real-time IQ transport: bounded ring buffer + paced consumer thread.
//
// A copy of the JAX package's native/ring_writer.cpp.
//
// Replacement for the reference's L1 transport layer — the
// pthread TX loop whose blocking iio_buffer_push paces the whole program
// to the sample rate (plutogpssim.c:2058-2190), and the mutex/condvar
// double-buffer handoff between the generator and the TX thread
// (c:2689-2759, 2146-2158).  Here the roles invert: the device produces IQ
// far faster than real time, so the producer (Python, holding device
// output blocks) pushes into a ring that ABSORBS the rate mismatch, and
// the consumer thread drains it to a file descriptor (file, pipe, UDP
// socket, SDR bridge) at an exactly-paced byte rate using absolute
// CLOCK_MONOTONIC deadlines (no drift accumulation, unlike the
// reference's sleep-per-buffer pacing).
//
// Built on demand with g++ (see utils/native.py); plain C ABI for ctypes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <pthread.h>
#include <unistd.h>

namespace {

constexpr uint64_t NSEC = 1000000000ull;

struct RingWriter {
    int fd = -1;
    bool close_fd = false;

    char *buf = nullptr;
    size_t cap = 0;            // bytes
    size_t head = 0;           // producer writes at head
    size_t tail = 0;           // consumer reads at tail
    size_t fill = 0;           // bytes currently queued

    // pacing: consumer emits chunk_bytes every chunk_ns (0 = unpaced)
    uint64_t chunk_bytes = 0;
    uint64_t chunk_ns = 0;
    // datagram mode: each write() is one packet; wait for a full chunk
    // (except at drain end) so packets keep their size and the ring's
    // chunk-aligned tail never splits one across the wrap boundary
    bool datagram = false;

    pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
    pthread_cond_t can_push = PTHREAD_COND_INITIALIZER;
    pthread_cond_t can_pop = PTHREAD_COND_INITIALIZER;
    pthread_t thread{};
    bool started = false;
    bool closing = false;      // no more pushes; drain and exit
    bool io_error = false;

    // stats
    std::atomic<uint64_t> bytes_written{0};
    std::atomic<uint64_t> producer_waits{0};   // pushes that blocked (ring full)
    std::atomic<uint64_t> consumer_waits{0};   // paced deadlines missed (underrun
                                               // on the producer side: ring empty
                                               // when the deadline arrived)
};

uint64_t now_ns() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return uint64_t(ts.tv_sec) * NSEC + uint64_t(ts.tv_nsec);
}

void sleep_until(uint64_t t_ns) {
    timespec ts{time_t(t_ns / NSEC), long(t_ns % NSEC)};
    while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr) == EINTR) {
    }
}

bool write_all(int fd, const char *p, size_t n, bool datagram) {
    while (n > 0) {
        ssize_t w = write(fd, p, n);
        if (w < 0) {
            if (errno == EINTR)
                continue;
            // fire-and-forget datagrams: transient delivery failures
            // (absent receiver, routing blip, full socket buffer) drop
            // the packet but must not kill the paced stream
            if (datagram && (errno == ECONNREFUSED || errno == EHOSTUNREACH ||
                             errno == ENETUNREACH || errno == ENETDOWN ||
                             errno == EHOSTDOWN || errno == ENOBUFS ||
                             errno == EPERM))
                return true;
            return false;
        }
        p += w;
        n -= size_t(w);
    }
    return true;
}

void *consumer_main(void *arg) {
    RingWriter *rw = static_cast<RingWriter *>(arg);
    const size_t chunk = rw->chunk_bytes ? rw->chunk_bytes : (1u << 20);
    uint64_t deadline = now_ns();

    for (;;) {
        pthread_mutex_lock(&rw->mu);
        size_t need = rw->datagram ? chunk : 1;
        while (rw->fill < need && !rw->closing)
            pthread_cond_wait(&rw->can_pop, &rw->mu);
        if (rw->fill == 0 && rw->closing) {
            pthread_mutex_unlock(&rw->mu);
            break;
        }
        size_t n = rw->fill < chunk ? rw->fill : chunk;
        size_t tail = rw->tail;
        pthread_mutex_unlock(&rw->mu);

        // paced mode: wait for this chunk's deadline before emitting
        if (rw->chunk_ns) {
            uint64_t t = now_ns();
            if (t + 1000 < deadline) {
                sleep_until(deadline);
            } else if (t > deadline + rw->chunk_ns) {
                rw->consumer_waits.fetch_add(1, std::memory_order_relaxed);
                deadline = t;  // resync after a stall
            }
            // advance proportionally to bytes actually emitted, so
            // sustained partial-chunk pops still pace to bytes_per_sec
            deadline += uint64_t(double(n) * double(rw->chunk_ns) /
                                 double(rw->chunk_bytes));
        }

        bool ok = true;
        size_t first = rw->cap - tail < n ? rw->cap - tail : n;
        ok = write_all(rw->fd, rw->buf + tail, first, rw->datagram);
        if (ok && first < n)
            ok = write_all(rw->fd, rw->buf, n - first, rw->datagram);

        pthread_mutex_lock(&rw->mu);
        rw->tail = (tail + n) % rw->cap;
        rw->fill -= n;
        if (!ok) {
            rw->io_error = true;
            rw->closing = true;  // stop accepting data
        }
        pthread_cond_broadcast(&rw->can_push);
        pthread_mutex_unlock(&rw->mu);

        if (!ok)
            break;
        rw->bytes_written.fetch_add(n, std::memory_order_relaxed);
    }
    return nullptr;
}

}  // namespace

extern "C" {

// bytes_per_sec <= 0 disables pacing (drain at I/O speed).
// chunk_bytes: pacing granularity (e.g. one 0.1 s block); 0 = 1 MiB.
// flags bit 0: datagram mode (each write() is one packet of chunk_bytes;
// capacity must be a chunk multiple).
void *rw_create(int fd, size_t capacity, double bytes_per_sec,
                size_t chunk_bytes, int flags) {
    if (fd < 0 || capacity == 0)
        return nullptr;
    if ((flags & 1) && (chunk_bytes == 0 || capacity % chunk_bytes != 0))
        return nullptr;
    RingWriter *rw = new RingWriter();
    rw->datagram = (flags & 1) != 0;
    rw->fd = fd;
    rw->cap = capacity;
    rw->buf = new (std::nothrow) char[capacity];
    if (!rw->buf) {
        delete rw;
        return nullptr;
    }
    if (bytes_per_sec > 0) {
        rw->chunk_bytes = chunk_bytes ? chunk_bytes : (1u << 20);
        rw->chunk_ns = uint64_t(double(rw->chunk_bytes) / bytes_per_sec * 1e9);
        if (rw->chunk_ns == 0)
            rw->chunk_ns = 1;
    } else if (chunk_bytes) {
        rw->chunk_bytes = chunk_bytes;
    }
    if (pthread_create(&rw->thread, nullptr, consumer_main, rw) != 0) {
        delete[] rw->buf;
        delete rw;
        return nullptr;
    }
    rw->started = true;
    return rw;
}

// Blocking push; returns 0 on success, -1 if the writer is closed/errored.
int rw_push(void *h, const void *data, size_t n) {
    RingWriter *rw = static_cast<RingWriter *>(h);
    const char *p = static_cast<const char *>(data);
    while (n > 0) {
        pthread_mutex_lock(&rw->mu);
        bool waited = false;
        while (rw->fill == rw->cap && !rw->closing) {
            waited = true;
            pthread_cond_wait(&rw->can_push, &rw->mu);
        }
        if (rw->closing) {
            pthread_mutex_unlock(&rw->mu);
            return -1;
        }
        if (waited)
            rw->producer_waits.fetch_add(1, std::memory_order_relaxed);
        size_t room = rw->cap - rw->fill;
        size_t m = n < room ? n : room;
        size_t head = rw->head;
        size_t first = rw->cap - head < m ? rw->cap - head : m;
        memcpy(rw->buf + head, p, first);
        if (first < m)
            memcpy(rw->buf, p + first, m - first);
        rw->head = (head + m) % rw->cap;
        rw->fill += m;
        pthread_cond_broadcast(&rw->can_pop);
        pthread_mutex_unlock(&rw->mu);
        p += m;
        n -= m;
    }
    return 0;
}

size_t rw_fill(void *h) {
    RingWriter *rw = static_cast<RingWriter *>(h);
    pthread_mutex_lock(&rw->mu);
    size_t f = rw->fill;
    pthread_mutex_unlock(&rw->mu);
    return f;
}

void rw_stats(void *h, uint64_t *bytes, uint64_t *producer_waits,
              uint64_t *consumer_waits) {
    RingWriter *rw = static_cast<RingWriter *>(h);
    if (bytes)
        *bytes = rw->bytes_written.load(std::memory_order_relaxed);
    if (producer_waits)
        *producer_waits = rw->producer_waits.load(std::memory_order_relaxed);
    if (consumer_waits)
        *consumer_waits = rw->consumer_waits.load(std::memory_order_relaxed);
}

// Drain remaining data, join the consumer, report final stats, free.
// Returns 0, or -1 if an I/O error occurred at any point.
int rw_close(void *h, uint64_t *bytes, uint64_t *producer_waits,
             uint64_t *consumer_waits) {
    RingWriter *rw = static_cast<RingWriter *>(h);
    pthread_mutex_lock(&rw->mu);
    rw->closing = true;
    pthread_cond_broadcast(&rw->can_pop);
    pthread_cond_broadcast(&rw->can_push);
    pthread_mutex_unlock(&rw->mu);
    if (rw->started)
        pthread_join(rw->thread, nullptr);
    rw_stats(h, bytes, producer_waits, consumer_waits);
    int rc = rw->io_error ? -1 : 0;
    delete[] rw->buf;
    delete rw;
    return rc;
}

}  // extern "C"
