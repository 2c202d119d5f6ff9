// Native batch assembly for the input pipeline.
//
// The reference delegates its hot host-side data path to PyTorch's C++
// DataLoader workers (SURVEY.md §2.14). This is our native equivalent for
// the operations that sit between Arrow storage and the TPU transfer:
// padded batch assembly (scatter of ragged float32/int32 rows into a
// fixed-shape buffer) done with OpenMP-free portable threads, plus int16→
// float32 PCM conversion for WAV ingestion. Exposed to Python via ctypes
// (see huggingface_asr_tpu/data/native_collate.py).
//
// Build:  g++ -O3 -shared -fPIC -std=c++17 -pthread collate.cpp -o libcollate.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Assemble a padded (B, max_len) float32 batch from B ragged rows.
// srcs: array of B pointers to float32 rows; lens: row lengths;
// out: preallocated B*max_len float32 buffer (will be zero-filled);
// out_lens: preallocated B int32 buffer.
void collate_f32(const float** srcs, const int64_t* lens, int64_t batch,
                 int64_t max_len, float* out, int32_t* out_lens,
                 int32_t num_threads) {
  std::memset(out, 0, sizeof(float) * batch * max_len);
  if (num_threads < 1) num_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      int64_t n = std::min(lens[i], max_len);
      std::memcpy(out + i * max_len, srcs[i], sizeof(float) * n);
      out_lens[i] = static_cast<int32_t>(n);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < num_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// Same for int32 label rows, with a fill value (e.g. pad id).
void collate_i32(const int32_t** srcs, const int64_t* lens, int64_t batch,
                 int64_t max_len, int32_t fill, int32_t* out,
                 int32_t* out_lens) {
  for (int64_t i = 0; i < batch; ++i) {
    int64_t n = std::min(lens[i], max_len);
    std::memcpy(out + i * max_len, srcs[i], sizeof(int32_t) * n);
    std::fill(out + i * max_len + n, out + (i + 1) * max_len, fill);
    out_lens[i] = static_cast<int32_t>(n);
  }
}

// int16 PCM -> float32 in [-1, 1), with optional trim of leading/trailing
// zero samples (the reference trims via np.trim_zeros, data_utils.py:173-177).
// Returns the number of samples written.
int64_t pcm16_to_f32(const int16_t* src, int64_t n, float* out, int trim) {
  int64_t start = 0, end = n;
  if (trim) {
    while (start < end && src[start] == 0) ++start;
    while (end > start && src[end - 1] == 0) --end;
  }
  const float scale = 1.0f / 32768.0f;
  for (int64_t i = start; i < end; ++i) out[i - start] = src[i] * scale;
  return end - start;
}

}  // extern "C"
