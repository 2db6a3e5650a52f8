// frame_pump: threaded RAW-frame batch assembler for the streaming runtime.
//
// Plays the transport/ingest role the ROS node plays in the reference
// (raw_image_pipeline_ros subscribes to an image topic and hands frames to
// the pipeline one at a time; here frames are read from storage by a pool
// of native threads and assembled into fixed-size batches so host IO
// overlaps with device compute).
//
// Frames are raw 8-bit buffers (Bayer or interleaved BGR) of a fixed
// frame_bytes size, optionally with a fixed per-file header offset (e.g.
// to skip a PGM/P5 header). Batches complete strictly in order; a bounded
// ring of batch slots applies backpressure to the readers.
//
// C ABI (used from Python via ctypes, see runtime/native.py):
//   fp_create(paths, n_paths, frame_bytes, header_skip, batch, slots,
//             readers) -> handle
//   fp_next_batch(handle, &data, &n_frames) -> 0 ok / 1 end-of-stream
//   fp_release_batch(handle)   // recycle the slot returned by next_batch
//   fp_destroy(handle)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

struct BatchSlot {
  std::vector<uint8_t> data;
  std::atomic<int> frames_done{0};
  int frames_expected = 0;
  bool ready = false;      // all frames read
  bool consumed = false;   // handed to the consumer and released
};

struct FramePump {
  std::vector<std::string> paths;
  size_t frame_bytes = 0;
  size_t header_skip = 0;
  int batch = 0;
  int n_slots = 0;

  std::vector<std::unique_ptr<BatchSlot>> slots;
  std::vector<std::thread> readers;

  std::atomic<size_t> next_frame{0};  // global frame index dispenser
  size_t n_batches = 0;

  std::mutex mu;
  std::condition_variable cv_ready;    // consumer waits for slot ready
  std::condition_variable cv_recycle;  // readers wait for slot recycled
  size_t consume_idx = 0;  // next batch index the consumer takes
  size_t recycled = 0;     // number of batches released by the consumer
  bool stop = false;

  int read_frame(const std::string& path, uint8_t* dst) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return -1;
    if (header_skip && fseek(f, (long)header_skip, SEEK_SET) != 0) {
      fclose(f);
      return -1;
    }
    size_t got = fread(dst, 1, frame_bytes, f);
    fclose(f);
    if (got != frame_bytes) {
      // short file: zero-fill the remainder rather than fail the stream
      memset(dst + got, 0, frame_bytes - got);
    }
    return 0;
  }

  void reader_loop() {
    for (;;) {
      size_t idx = next_frame.fetch_add(1);
      if (idx >= paths.size()) return;
      size_t b = idx / batch;
      int pos = (int)(idx % batch);
      BatchSlot* slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait until batch b's slot is recycled (bounded ring)
        cv_recycle.wait(lk, [&] { return stop || b < recycled + n_slots; });
        if (stop) return;
        slot = slots[b % n_slots].get();
      }
      read_frame(paths[idx], slot->data.data() + (size_t)pos * frame_bytes);
      int done = slot->frames_done.fetch_add(1) + 1;
      if (done == slot->frames_expected) {
        std::lock_guard<std::mutex> lk(mu);
        slot->ready = true;
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* fp_create(const char** paths, int n_paths, uint64_t frame_bytes,
                uint64_t header_skip, int batch, int n_slots, int readers) {
  if (n_paths <= 0 || batch <= 0 || n_slots <= 1 || readers <= 0) return nullptr;
  auto* p = new FramePump();
  p->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
  p->frame_bytes = frame_bytes;
  p->header_skip = header_skip;
  p->batch = batch;
  p->n_slots = n_slots;
  p->n_batches = ((size_t)n_paths + batch - 1) / batch;
  p->slots.reserve(n_slots);
  for (int i = 0; i < n_slots; i++) {
    p->slots.emplace_back(new BatchSlot());
    p->slots.back()->data.resize((size_t)batch * frame_bytes);
  }
  // pre-compute expected frame counts lazily per cycle: set for first pass
  for (int i = 0; i < n_slots; i++) {
    size_t b = (size_t)i;
    if (b < p->n_batches) {
      size_t start = b * batch;
      size_t end = std::min(p->paths.size(), start + batch);
      p->slots[i]->frames_expected = (int)(end - start);
    }
  }
  for (int i = 0; i < readers; i++)
    p->readers.emplace_back([p] { p->reader_loop(); });
  return p;
}

int fp_next_batch(void* handle, uint8_t** data, int* n_frames) {
  auto* p = (FramePump*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->consume_idx >= p->n_batches) return 1;  // end of stream
  BatchSlot& slot = *p->slots[p->consume_idx % p->n_slots];
  p->cv_ready.wait(lk, [&] { return p->stop || slot.ready; });
  if (p->stop) return 1;
  *data = slot.data.data();
  *n_frames = slot.frames_expected;
  return 0;
}

void fp_release_batch(void* handle) {
  auto* p = (FramePump*)handle;
  std::lock_guard<std::mutex> lk(p->mu);
  BatchSlot& slot = *p->slots[p->consume_idx % p->n_slots];
  // re-arm the slot for the batch that will reuse it
  slot.ready = false;
  slot.frames_done.store(0);
  size_t future_b = p->consume_idx + p->n_slots;
  if (future_b < p->n_batches) {
    size_t start = future_b * p->batch;
    size_t end = std::min(p->paths.size(), start + p->batch);
    slot.frames_expected = (int)(end - start);
  }
  p->consume_idx++;
  p->recycled++;
  p->cv_recycle.notify_all();
}

void fp_destroy(void* handle) {
  auto* p = (FramePump*)handle;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_ready.notify_all();
    p->cv_recycle.notify_all();
  }
  for (auto& t : p->readers) t.join();
  delete p;
}

}  // extern "C"
