// Native prefetching batch loader: mmapped arrays -> shuffled, augmented,
// ready-to-device batches, produced by worker threads ahead of the
// training step.
//
// The device-side training loop (tools/train.py) is jit-bound; the host's
// job is to have the NEXT batch's bytes contiguous before step N
// returns. This loader mmaps an images array ([N,C,H,W] f32) and a
// labels array ([N] i64), and a small thread pool fills a bounded ring
// of batch slots:
//
//   - per-epoch deterministic shuffle (mt19937_64(seed+epoch)), shared
//     by every worker — batch K of epoch E is the same set of samples
//     regardless of thread count;
//   - per-sample deterministic augmentation (horizontal flip, keyed by
//     splitmix64(seed, epoch, index)) — reproducible runs;
//   - consumers receive batches IN ORDER (slot seq numbers), so the
//     stream is bit-identical to a single-threaded loader.
//
// Python binding: interactive_vit_tpu/data/loader.py (ctypes), with a
// numpy fallback implementing the same contract (parity-tested).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

struct Mapped {
    const uint8_t* base = nullptr;
    size_t len = 0;
    int fd = -1;

    bool open_at(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) return false;
        len = static_cast<size_t>(st.st_size);
        void* p = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) return false;
        base = static_cast<const uint8_t*>(p);
        return true;
    }

    ~Mapped() {
        if (base) munmap(const_cast<uint8_t*>(base), len);
        if (fd >= 0) ::close(fd);
    }
};

struct Slot {
    std::vector<float> images;
    std::vector<int64_t> labels;
    uint64_t seq = ~0ULL;  // which global batch this slot holds
    bool ready = false;
};

struct Loader {
    Mapped images_map, labels_map;
    const float* images = nullptr;    // [n, item_floats]
    const int64_t* labels = nullptr;  // [n]
    uint64_t n = 0, item_floats = 0;
    uint32_t c = 0, h = 0, w = 0;
    uint32_t batch = 0;
    uint64_t seed = 0;
    bool flip = false;

    uint64_t batches_per_epoch = 0;  // drop-last

    std::vector<Slot> slots;
    std::vector<std::thread> workers;
    std::atomic<uint64_t> next_batch{0};  // producer ticket
    uint64_t consumed = 0;                // consumer cursor
    std::mutex mu;
    std::condition_variable cv_ready, cv_free;
    bool stopping = false;
    bool failed = false;    // a worker threw (e.g. bad_alloc): consumers
                            // get -1 instead of the process terminating
    bool borrowed = false;  // a borrow is outstanding (release's guard)

    // epoch -> shuffled indices (cached for the CURRENT producer epochs;
    // workers near an epoch boundary may need two)
    std::mutex perm_mu;
    uint64_t perm_epoch = ~0ULL, perm_epoch2 = ~0ULL;
    std::vector<uint64_t> perm, perm2;

    const std::vector<uint64_t>& epoch_perm(uint64_t epoch) {
        std::lock_guard<std::mutex> g(perm_mu);
        if (epoch == perm_epoch) return perm;
        if (epoch == perm_epoch2) return perm2;
        std::vector<uint64_t>& tgt = (epoch % 2 == 0) ? perm : perm2;
        uint64_t& tag = (epoch % 2 == 0) ? perm_epoch : perm_epoch2;
        tgt.resize(n);
        std::iota(tgt.begin(), tgt.end(), 0);
        std::mt19937_64 rng(seed + epoch);
        for (uint64_t i = n; i > 1; --i) {
            uint64_t j = rng() % i;
            std::swap(tgt[i - 1], tgt[j]);
        }
        tag = epoch;
        return tgt;
    }

    void fill(Slot& slot, uint64_t global_batch) {
        uint64_t epoch = global_batch / batches_per_epoch;
        uint64_t b = global_batch % batches_per_epoch;
        const std::vector<uint64_t>& p = epoch_perm(epoch);
        slot.images.resize(static_cast<size_t>(batch) * item_floats);
        slot.labels.resize(batch);
        const uint64_t plane = static_cast<uint64_t>(h) * w;
        for (uint32_t k = 0; k < batch; ++k) {
            uint64_t idx = p[b * batch + k];
            const float* src = images + idx * item_floats;
            float* dst = slot.images.data() +
                         static_cast<uint64_t>(k) * item_floats;
            bool do_flip =
                flip && (splitmix64(seed ^ (epoch * 0x9e37ULL) ^ idx) & 1);
            if (!do_flip) {
                std::memcpy(dst, src, item_floats * sizeof(float));
            } else {
                for (uint32_t ch = 0; ch < c; ++ch) {
                    const float* sp = src + ch * plane;
                    float* dp = dst + ch * plane;
                    for (uint32_t y = 0; y < h; ++y) {
                        for (uint32_t x = 0; x < w; ++x) {
                            dp[y * w + x] = sp[y * w + (w - 1 - x)];
                        }
                    }
                }
            }
            slot.labels[k] = labels[idx];
        }
        slot.seq = global_batch;
    }

    void worker() {
        // an exception escaping a std::thread entry point calls
        // std::terminate — host memory pressure (bad_alloc on a slot
        // resize) must surface as a consumer-visible error instead
        try {
            worker_loop();
        } catch (...) {
            {
                std::lock_guard<std::mutex> lk(mu);
                failed = true;
                stopping = true;
            }
            cv_ready.notify_all();
            cv_free.notify_all();
        }
    }

    void worker_loop() {
        for (;;) {
            uint64_t ticket = next_batch.fetch_add(1);
            uint64_t slot_i = ticket % slots.size();
            Slot& slot = slots[slot_i];
            {
                // wait until the consumer has drained this slot's
                // previous occupant (ticket - depth)
                std::unique_lock<std::mutex> lk(mu);
                cv_free.wait(lk, [&] {
                    return stopping ||
                           ticket < consumed + slots.size();
                });
                if (stopping) return;
            }
            fill(slot, ticket);
            {
                std::lock_guard<std::mutex> lk(mu);
                slot.ready = true;
            }
            cv_ready.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* ivt_loader_open(const char* images_path, uint64_t images_offset,
                      const char* labels_path, uint64_t labels_offset,
                      uint64_t n, uint32_t c, uint32_t h, uint32_t w,
                      uint32_t batch, uint32_t depth, uint32_t threads,
                      uint64_t seed, int flip) {
    if (!n || !batch || batch > n) return nullptr;
    auto* L = new Loader();
    if (!L->images_map.open_at(images_path) ||
        !L->labels_map.open_at(labels_path)) {
        delete L;
        return nullptr;
    }
    L->item_floats = static_cast<uint64_t>(c) * h * w;
    // overflow-guarded size math: a corrupt .npy header claiming a huge
    // n/shape would wrap the byte count to a small value and defeat the
    // truncation check below (then fault or bad_alloc later)
    if (!L->item_floats ||
        n > SIZE_MAX / sizeof(float) / L->item_floats ||
        n > SIZE_MAX / sizeof(int64_t)) {
        delete L;
        return nullptr;
    }
    size_t img_bytes = n * L->item_floats * sizeof(float);
    size_t lab_bytes = n * sizeof(int64_t);
    if (images_offset > L->images_map.len ||
        labels_offset > L->labels_map.len ||
        L->images_map.len - images_offset < img_bytes ||
        L->labels_map.len - labels_offset < lab_bytes) {
        delete L;
        return nullptr;  // truncated file: refuse instead of faulting
    }
    L->images = reinterpret_cast<const float*>(L->images_map.base +
                                               images_offset);
    L->labels = reinterpret_cast<const int64_t*>(L->labels_map.base +
                                                 labels_offset);
    L->n = n;
    L->c = c; L->h = h; L->w = w;
    L->batch = batch;
    L->seed = seed;
    L->flip = flip != 0;
    L->batches_per_epoch = n / batch;  // drop-last
    if (!L->batches_per_epoch) {
        delete L;
        return nullptr;
    }
    if (depth < 2) depth = 2;
    // in-flight tickets must span at most TWO epochs: the permutation
    // cache holds exactly two (parity-keyed), and a third concurrent
    // epoch would regenerate a vector another worker is reading (a
    // window of size bpe+1 crosses at most one epoch boundary; the old
    // bpe>=2 guard left bpe==1 racy — reproduced as 24/200 divergent
    // batches, review r3)
    if (depth > L->batches_per_epoch + 1) {
        depth = static_cast<uint32_t>(L->batches_per_epoch + 1);
    }
    if (depth < 2) depth = 2;
    if (threads < 1) threads = 1;
    if (threads > depth) threads = depth;
    L->slots.resize(depth);
    for (uint32_t t = 0; t < threads; ++t) {
        L->workers.emplace_back([L] { L->worker(); });
    }
    return L;
}

// Blocks until the next IN-ORDER batch is ready, copies it out, and
// frees the slot. Returns the epoch number of the copied batch.
int64_t ivt_loader_next(void* handle, float* out_images,
                        int64_t* out_labels) {
    auto* L = static_cast<Loader*>(handle);
    uint64_t want = L->consumed;
    Slot& slot = L->slots[want % L->slots.size()];
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] {
            return L->failed || (slot.ready && slot.seq == want);
        });
        if (L->failed) return -1;
    }
    std::memcpy(out_images, slot.images.data(),
                slot.images.size() * sizeof(float));
    std::memcpy(out_labels, slot.labels.data(),
                slot.labels.size() * sizeof(int64_t));
    {
        std::lock_guard<std::mutex> lk(L->mu);
        slot.ready = false;
        L->consumed = want + 1;
    }
    L->cv_free.notify_all();
    return static_cast<int64_t>(want / L->batches_per_epoch);
}

// Zero-copy variant: lends pointers INTO the ready slot (valid until
// ivt_loader_release). Saves the 77 MB/batch consumer memcpy — the
// host-bandwidth-bound case; the caller (train loop) device_puts the
// borrowed buffer and releases before the next borrow.
int64_t ivt_loader_borrow(void* handle, const float** images,
                          const int64_t** labels) {
    auto* L = static_cast<Loader*>(handle);
    uint64_t want = L->consumed;
    Slot& slot = L->slots[want % L->slots.size()];
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] {
            return L->failed || (slot.ready && slot.seq == want);
        });
        if (L->failed) return -1;
        L->borrowed = true;
    }
    *images = slot.images.data();
    *labels = slot.labels.data();
    return static_cast<int64_t>(want / L->batches_per_epoch);
}

// Releases the slot lent by the LAST ivt_loader_borrow.
void ivt_loader_release(void* handle) {
    auto* L = static_cast<Loader*>(handle);
    uint64_t want = L->consumed;
    Slot& slot = L->slots[want % L->slots.size()];
    {
        std::lock_guard<std::mutex> lk(L->mu);
        // explicit borrow bookkeeping: the previous "slot looks ready"
        // heuristic let a stray release (double release, or release
        // without borrow) silently consume and drop an unborrowed
        // batch — an untraceable determinism break
        if (!L->borrowed) return;
        L->borrowed = false;
        slot.ready = false;
        L->consumed = want + 1;
    }
    L->cv_free.notify_all();
}

void ivt_loader_close(void* handle) {
    auto* L = static_cast<Loader*>(handle);
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->stopping = true;
    }
    L->cv_free.notify_all();
    for (auto& t : L->workers) t.join();
    delete L;
}

}  // extern "C"
