// Async tensor I/O engine for NVMe offload (ZeRO-Infinity).
//
// Reference parity: csrc/aio/ — `aio_handle` (deepspeed_py_aio_handle.cpp:14-40)
// exposes a thread-pool + libaio queue doing O_DIRECT reads/writes of tensors;
// swappers above it stream param/optimizer partitions to NVMe.
//
// TPU-native rebuild: a dependency-free C++17 thread pool where every request
// is split into per-thread file chunks served with pread/pwrite. O_DIRECT is
// used when buffer/size/offset alignment permits (callers allocate 4096-aligned
// padded buffers via the Python helper), falling back to page-cache I/O
// otherwise. C ABI for ctypes; no torch, no pybind11.

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kAlign = 4096;

struct Chunk {
    int op;  // 0 = read, 1 = write
    void* buf;
    std::string path;
    int64_t offset;
    int64_t nbytes;
    bool try_direct;
    std::atomic<int>* remaining;  // owned by the request
};

struct Handle {
    int n_threads;
    int64_t block_size;
    std::vector<std::thread> workers;
    std::deque<Chunk> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::atomic<int64_t> inflight{0};
    std::atomic<int64_t> errors{0};
    std::atomic<int> last_errno{0};
    std::atomic<bool> stop{false};

    explicit Handle(int threads, int64_t block) : n_threads(threads), block_size(block) {
        for (int i = 0; i < n_threads; ++i) workers.emplace_back([this] { run(); });
    }

    ~Handle() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }

    void run() {
        for (;;) {
            Chunk c;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                c = std::move(queue.front());
                queue.pop_front();
            }
            if (!do_io(c)) {
                errors.fetch_add(1);
                last_errno.store(errno);
            }
            if (c.remaining->fetch_sub(1) == 1) delete c.remaining;
            {
                // decrement under the lock: otherwise a waiter that just saw
                // inflight==1 can miss the notify and sleep forever
                std::lock_guard<std::mutex> lk(mu);
                inflight.fetch_sub(1);
            }
            cv.notify_all();
        }
    }

    static bool do_io(const Chunk& c) {
        int flags = c.op == 0 ? O_RDONLY : (O_WRONLY | O_CREAT);
        bool direct = c.try_direct &&
                      (reinterpret_cast<uintptr_t>(c.buf) % kAlign == 0) &&
                      (c.offset % kAlign == 0) && (c.nbytes % kAlign == 0);
        int fd = -1;
#ifdef O_DIRECT
        if (direct) fd = ::open(c.path.c_str(), flags | O_DIRECT, 0644);
#endif
        if (fd < 0) fd = ::open(c.path.c_str(), flags, 0644);
        if (fd < 0) return false;
        char* p = static_cast<char*>(c.buf);
        int64_t left = c.nbytes, off = c.offset;
        bool ok = true;
        while (left > 0) {
            ssize_t n = c.op == 0 ? ::pread(fd, p, static_cast<size_t>(left), off)
                                  : ::pwrite(fd, p, static_cast<size_t>(left), off);
            if (n <= 0) {
                ok = false;
                break;
            }
            p += n;
            off += n;
            left -= n;
        }
        ::close(fd);
        return ok;
    }

    void submit(int op, void* buf, const char* path, int64_t nbytes, bool try_direct) {
        // split into block_size chunks across the pool (reference block_size
        // semantics: per-aio-call granularity)
        int64_t nchunks = (nbytes + block_size - 1) / block_size;
        if (nchunks < 1) nchunks = 1;
        auto* remaining = new std::atomic<int>(static_cast<int>(nchunks));
        {
            std::lock_guard<std::mutex> lk(mu);
            for (int64_t i = 0; i < nchunks; ++i) {
                int64_t off = i * block_size;
                int64_t len = std::min(block_size, nbytes - off);
                inflight.fetch_add(1);
                queue.push_back(Chunk{op, static_cast<char*>(buf) + off, path, off,
                                      len, try_direct, remaining});
            }
        }
        cv.notify_all();
    }

    int64_t wait() {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return inflight.load() == 0; });
        return errors.exchange(0);
    }
};

}  // namespace

extern "C" {

void* ds_aio_handle_new(int64_t block_size, int n_threads) {
    if (block_size <= 0) block_size = 1 << 20;
    if (n_threads <= 0) n_threads = 8;
    return new Handle(n_threads, block_size);
}

void ds_aio_handle_free(void* h) { delete static_cast<Handle*>(h); }

// async submit; completion via ds_aio_wait
void ds_aio_pread(void* h, void* buf, const char* path, int64_t nbytes) {
    static_cast<Handle*>(h)->submit(0, buf, path, nbytes, true);
}

void ds_aio_pwrite(void* h, void* buf, const char* path, int64_t nbytes) {
    static_cast<Handle*>(h)->submit(1, buf, path, nbytes, true);
}

// blocks until all inflight I/O completes; returns error count since last wait
int64_t ds_aio_wait(void* h) { return static_cast<Handle*>(h)->wait(); }

int64_t ds_aio_inflight(void* h) { return static_cast<Handle*>(h)->inflight.load(); }

int ds_aio_last_errno(void* h) { return static_cast<Handle*>(h)->last_errno.exchange(0); }

}  // extern "C"
