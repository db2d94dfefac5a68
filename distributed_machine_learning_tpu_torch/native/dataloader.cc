// Native batch-assembly loader (the PyTorch port's copy of the reference
// package's native/dataloader.cc): the runtime role torch's C++ DataLoader
// (pin_memory workers — reference part2/2a/main.py:162-167) plays, built
// for the host side: a worker thread gathers dataset rows into batch
// buffers ahead of the training loop behind a bounded queue, overlapping
// host memcpy/IO with device compute.
//
// C ABI (consumed by data/native_loader.py via ctypes):
//   dl_create  — start a loader over (images, labels) with a fixed epoch
//                index order and batch size; spawns the worker thread.
//   dl_next    — blocking pop of the next batch into caller buffers;
//                returns the row count (0 = end of epoch).
//   dl_destroy — stop the worker (even mid-epoch: the training loop's
//                40-iteration cap abandons epochs routinely) and free.
//
// The caller owns the dataset memory and must keep it alive for the
// handle's lifetime; batches are copied into loader-owned buffers, so
// dl_next never aliases dataset or queue memory.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<uint8_t> images;
  std::vector<int32_t> labels;
  int64_t rows = 0;
};

struct Loader {
  const uint8_t* images = nullptr;
  const int32_t* labels = nullptr;
  int64_t row_bytes = 0;
  std::vector<int64_t> indices;
  int64_t batch = 0;
  size_t depth = 1;

  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_space;  // producer waits for queue space
  std::condition_variable cv_item;   // consumer waits for an item
  bool stop = false;
  bool done = false;
  std::thread worker;

  void Run() {
    const int64_t n = static_cast<int64_t>(indices.size());
    for (int64_t start = 0; start < n; start += batch) {
      const int64_t rows = std::min(batch, n - start);
      Batch b;
      b.rows = rows;
      b.images.resize(static_cast<size_t>(rows) * row_bytes);
      b.labels.resize(static_cast<size_t>(rows));
      for (int64_t i = 0; i < rows; ++i) {
        const int64_t src = indices[static_cast<size_t>(start + i)];
        std::memcpy(b.images.data() + static_cast<size_t>(i) * row_bytes,
                    images + src * row_bytes,
                    static_cast<size_t>(row_bytes));
        b.labels[static_cast<size_t>(i)] = labels[src];
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return queue.size() < depth || stop; });
      if (stop) return;
      queue.push_back(std::move(b));
      cv_item.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_item.notify_all();
  }
};

}  // namespace

extern "C" {

void* dl_create(const uint8_t* images, const int32_t* labels,
                int64_t row_bytes, const int64_t* indices, int64_t n_indices,
                int64_t batch_size, int64_t prefetch_depth) {
  if (images == nullptr || labels == nullptr || indices == nullptr ||
      row_bytes <= 0 || n_indices < 0 || batch_size <= 0) {
    return nullptr;
  }
  auto* l = new Loader();
  l->images = images;
  l->labels = labels;
  l->row_bytes = row_bytes;
  l->indices.assign(indices, indices + n_indices);
  l->batch = batch_size;
  l->depth = static_cast<size_t>(std::max<int64_t>(1, prefetch_depth));
  l->worker = std::thread([l] { l->Run(); });
  return l;
}

int64_t dl_next(void* handle, uint8_t* out_images, int32_t* out_labels) {
  auto* l = static_cast<Loader*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_item.wait(lk, [&] { return !l->queue.empty() || l->done; });
    if (l->queue.empty()) return 0;
    b = std::move(l->queue.front());
    l->queue.pop_front();
    l->cv_space.notify_one();
  }
  std::memcpy(out_images, b.images.data(), b.images.size());
  std::memcpy(out_labels, b.labels.data(), b.rows * sizeof(int32_t));
  return b.rows;
}

void dl_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
    l->cv_space.notify_all();
    l->cv_item.notify_all();
  }
  if (l->worker.joinable()) l->worker.join();
  delete l;
}

}  // extern "C"
