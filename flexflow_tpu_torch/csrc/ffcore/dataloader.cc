// Native batch loader (reference parity: src/dataloader/dataloader.cc —
// the reference's SingleDataLoader stages the full dataset in zero-copy
// host memory and launches per-batch copy tasks; here a C++ producer
// thread gathers (optionally shuffled) sample rows into a ring of
// contiguous batch buffers ahead of the consumer, overlapping host gather
// with device compute. Python (flexflow_tpu.native.BatchStream) device_puts
// each prepared buffer.
//
// C ABI (ctypes):
//   ffdl_create(data, n_samples, sample_bytes, batch, shuffle, seed, depth)
//   ffdl_next(h)    -> const void*  (blocks; buffer valid until next call)
//   ffdl_epoch(h)   -> long         (epoch of the batch ffdl_next returned)
//   ffdl_reset(h)                   (restart at epoch 0, reshuffle)
//   ffdl_destroy(h)
//
// Drop-in semantics match the Python loader: batches tile the first
// num_batches * batch samples of each epoch; shuffling permutes sample
// order per epoch with a deterministic seeded RNG.
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Loader {
  const uint8_t* data;
  int64_t n_samples;
  int64_t sample_bytes;
  int64_t batch;
  bool shuffle;
  uint64_t seed;

  int64_t n_batches;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<int64_t> ring_epoch;
  int64_t head = 0;  // next slot the producer fills (monotonic)
  int64_t tail = 0;  // next slot the consumer takes (monotonic)
  int64_t produced_batch = 0;  // batch index within the producer's epoch
  int64_t producer_epoch = 0;
  int64_t consumer_epoch = 0;
  int64_t generation = 0;  // bumped by reset: discards in-flight fills
  std::vector<int64_t> order;

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  bool stop = false;
  std::thread worker;

  void reshuffle() {
    order.resize(n_samples);
    for (int64_t i = 0; i < n_samples; ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(producer_epoch));
      std::shuffle(order.begin(), order.end(), rng);
    }
  }

  // gathers rows given a snapshot of this batch's indices; the snapshot is
  // taken under the mutex so ffdl_reset's reshuffle() never races the read
  void fill(std::vector<uint8_t>& buf, const std::vector<int64_t>& idx) {
    uint8_t* out = buf.data();
    for (int64_t i = 0; i < batch; ++i) {
      std::memcpy(out + i * sample_bytes, data + idx[i] * sample_bytes,
                  static_cast<size_t>(sample_bytes));
    }
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    reshuffle();
    while (!stop) {
      // keep one slot of margin: the buffer ffdl_next just handed out
      // (tail - 1) must stay untouched until the consumer's next call
      cv_produce.wait(lk, [&] {
        return stop || head - tail < static_cast<int64_t>(ring.size()) - 1;
      });
      if (stop) return;
      const int64_t slot = head % ring.size();
      const int64_t epoch = producer_epoch;
      const int64_t gen = generation;
      const int64_t base = produced_batch * batch;
      const std::vector<int64_t> idx(order.begin() + base,
                                     order.begin() + base + batch);
      // gather outside the lock: the consumer only touches slots < head,
      // and idx is a private snapshot (reset may reshuffle `order`)
      lk.unlock();
      fill(ring[slot], idx);
      lk.lock();
      if (gen != generation) continue;  // reset raced the fill: discard
      ring_epoch[slot] = epoch;
      ++head;
      if (++produced_batch >= n_batches) {
        produced_batch = 0;
        ++producer_epoch;
        reshuffle();
      }
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* ffdl_create(const void* data, int64_t n_samples, int64_t sample_bytes,
                  int64_t batch, int shuffle, uint64_t seed, int depth) {
  if (!data || n_samples <= 0 || sample_bytes <= 0 || batch <= 0 ||
      batch > n_samples || depth < 2) {
    return nullptr;
  }
  auto* l = new Loader();
  l->data = static_cast<const uint8_t*>(data);
  l->n_samples = n_samples;
  l->sample_bytes = sample_bytes;
  l->batch = batch;
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->n_batches = n_samples / batch;
  l->ring.resize(depth);
  l->ring_epoch.assign(depth, 0);
  for (auto& b : l->ring)
    b.resize(static_cast<size_t>(batch * sample_bytes));
  l->worker = std::thread([l] { l->run(); });
  return l;
}

const void* ffdl_next(void* h) {
  auto* l = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_consume.wait(lk, [&] { return l->head > l->tail; });
  const int64_t slot = l->tail % l->ring.size();
  l->consumer_epoch = l->ring_epoch[slot];
  ++l->tail;  // the PREVIOUS buffer becomes reusable; this one stays valid
              // until the next ffdl_next (producer never gets closer than
              // head - tail < depth)
  l->cv_produce.notify_one();
  return l->ring[slot].data();
}

int64_t ffdl_epoch(void* h) {
  auto* l = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(l->mu);
  return l->consumer_epoch;
}

void ffdl_reset(void* h) {
  auto* l = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  // drop everything staged (and any in-flight fill, via the generation
  // bump) and restart from epoch 0 batch 0
  l->tail = l->head;
  l->produced_batch = 0;
  l->producer_epoch = 0;
  l->consumer_epoch = 0;
  ++l->generation;
  l->reshuffle();
  l->cv_produce.notify_one();
}

void ffdl_destroy(void* h) {
  auto* l = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
  }
  l->cv_produce.notify_all();
  l->worker.join();
  delete l;
}

}  // extern "C"
