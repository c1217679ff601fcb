// PyTorch bindings of the port's CUDA kernels: the one translation unit
// that includes PyTorch's headers (the .cu sources expose plain C++
// launchers taking raw pointers and a stream).  Each wrapper checks
// device, dtype, shape and contiguity, allocates the outputs, launches on
// PyTorch's current stream and checks the launch right after it.
//
// Every TORCH_CHECK here takes ONE message, a literal or a std::string
// joined with `+` and std::to_string.  With several message arguments
// TORCH_CHECK joins them through a std::ostringstream (c10::str), and a
// std::ostringstream in this extension crashed the process (SIGSEGV) on
// the machine with the card, so a failed check killed the process
// instead of raising RuntimeError.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

#include <string>
#include <vector>

cudaError_t launch_gls_row_race(const float* log_s, const float* log_q,
                                float* rmin, int* rarg, int rows, int n,
                                int splits, int chunk, cudaStream_t stream);
int gls_row_race_max_splits();
cudaError_t launch_decode_attention(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* out, int B, int H, int Hkv, int T,
                                    int D, int splits, int chunk,
                                    cudaStream_t stream);
cudaError_t launch_decode_attention_int8(const float* q, const int8_t* k,
                                         const int8_t* v,
                                         const float* k_scale,
                                         const float* v_scale,
                                         const int* kv_len, float* out, int B,
                                         int H, int Hkv, int T, int D,
                                         int splits, int chunk, int slots,
                                         cudaStream_t stream);
cudaError_t launch_decode_attention_int8_floor(
    const float* q, const int8_t* k, const int8_t* v, const float* k_scale,
    const float* v_scale, const int* kv_len, float* out, int B, int H,
    int Hkv, int T, int D, int splits, int chunk, int slots,
    cudaStream_t stream);
cudaError_t launch_decode_attention_group_floor(
    const float* q, const float* k, const float* v, const int* kv_len,
    float* out, int B, int H, int Hkv, int T, int D, int splits, int chunk,
    cudaStream_t stream);
bool decode_attention_has_head_dim(int d);
int decode_attention_max_splits();
int decode_group_slots(int group);
cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, const int* q_offset,
                                   const int* kv_len, float* out, int B, int H,
                                   int Hkv, int S, int T, int D, int window,
                                   int causal, cudaStream_t stream);
cudaError_t launch_flash_attention_int8(const float* q, const int8_t* k,
                                        const int8_t* v, const float* k_scale,
                                        const float* v_scale,
                                        const int* q_offset, const int* kv_len,
                                        float* out, int B, int H, int Hkv,
                                        int S, int T, int D, int window,
                                        int causal, cudaStream_t stream);
bool flash_attention_has_head_dim(int d);
void launch_gls_binned_race(const float* log_s, const float* log_q,
                            const int* bins, float* bmin, int* barg,
                            int batch, int rows_per_batch, int n, int l_max,
                            cudaStream_t stream);
int gls_binned_race_max_bins();
cudaError_t launch_gls_race(const float* log_s, const float* log_p,
                            const float* log_q, const bool* active, int* x,
                            int* y, int batch, int k_drafts, int n, int kc,
                            cudaStream_t stream);
cudaError_t launch_gls_race_floor(const float* log_s, const float* log_p,
                                  const float* log_q, const bool* active,
                                  int* x, int* y, int batch, int k_drafts,
                                  int n, int kc, cudaStream_t stream);
int gls_race_max_splits();
cudaError_t launch_ssd_chunk(const float* x, const float* dt, const float* a,
                             const float* b_in, const float* c_in, float* y,
                             float* states, float* total, int batch,
                             int n_chunks, int n_heads, cudaStream_t stream);
int ssd_chunk_tile_q();
int ssd_chunk_tile_p();
int ssd_chunk_tile_n();

namespace {

void check_tensor(const torch::Tensor& t, const char* name,
                  torch::ScalarType dtype, int64_t dim) {
  const std::string n(name);
  TORCH_CHECK(t.is_cuda(), n + " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, n + " has dtype " +
              c10::toString(t.scalar_type()) + ", expected " +
              c10::toString(dtype));
  TORCH_CHECK(t.dim() == dim, n + " must have " + std::to_string(dim) +
              " dims, got " + std::to_string(t.dim()));
  TORCH_CHECK(t.is_contiguous(), n + " must be contiguous");
}

void check_same_device(const torch::Tensor& a, const torch::Tensor& b) {
  TORCH_CHECK(a.device() == b.device(), "tensors on different devices: " +
              a.device().str() + " vs " + b.device().str());
}

// A split plan (ops.py): 1..max_splits blocks per cluster whose ranges
// of `chunk` items (a multiple of `multiple`) cover the `n` items.
void check_split_plan(const char* kernel, int64_t splits, int64_t chunk,
                      int64_t n, int max_splits, int64_t multiple) {
  TORCH_CHECK(splits >= 1 && splits <= max_splits && chunk >= 1 &&
              chunk % multiple == 0 && splits * chunk >= n &&
              chunk < INT32_MAX,
              std::string(kernel) + ": split plan (" +
              std::to_string(splits) + ", " + std::to_string(chunk) +
              ") does not cover " + std::to_string(n) + " items in at most " +
              std::to_string(max_splits) + " ranges of a multiple of " +
              std::to_string(multiple));
}

void check_aligned16(const char* what, const torch::Tensor& t) {
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0,
              std::string(what) + " must be 16-byte aligned");
}

// A refused launch raises (and is cleared, so the next kernel's check
// does not report it again); nothing falls back.
void check_launch(const char* kernel, cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  TORCH_CHECK(err == cudaSuccess, std::string(kernel) +
              ": cluster launch failed: " + cudaGetErrorString(err));
}

// The attention kernels are compiled for head dims 64 and 128.
void check_head_dim(const char* kernel, int64_t d, bool compiled) {
  TORCH_CHECK(compiled, std::string(kernel) + ": head dim " +
              std::to_string(d) + " not compiled (only 64 and 128)");
}

// The int8 K/V of an attention kernel: int8 k/v (B, Hkv, T, D), 16-byte
// aligned (copied in 16-byte pieces), and float32 scales (B, Hkv, T, 1).
void check_int8_kv(const char* kernel, const torch::Tensor& q,
                   const torch::Tensor& k, const torch::Tensor& v,
                   const torch::Tensor& k_scale,
                   const torch::Tensor& v_scale) {
  check_tensor(k, "k", torch::kInt8, 4);
  check_tensor(v, "v", torch::kInt8, 4);
  check_tensor(k_scale, "k_scale", torch::kFloat32, 4);
  check_tensor(v_scale, "v_scale", torch::kFloat32, 4);
  check_same_device(q, k);
  check_same_device(q, v);
  check_same_device(q, k_scale);
  check_same_device(q, v_scale);
  TORCH_CHECK(k.sizes() == v.sizes(), std::string(kernel) +
              ": k/v shape mismatch");
  TORCH_CHECK(k_scale.sizes() == v_scale.sizes() &&
              k_scale.size(0) == k.size(0) && k_scale.size(1) == k.size(1) &&
              k_scale.size(2) == k.size(2) && k_scale.size(3) == 1,
              std::string(kernel) + ": k_scale/v_scale must be (B, Hkv, T, 1)"
              " of k (B, Hkv, T, D)");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(k.data_ptr()) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(v.data_ptr()) % 16 == 0,
              std::string(kernel) + ": k and v must be 16-byte aligned");
}

}  // namespace

std::vector<torch::Tensor> gls_row_race(torch::Tensor log_s,
                                        torch::Tensor log_q, int64_t splits,
                                        int64_t chunk) {
  check_tensor(log_s, "log_s", torch::kFloat32, 3);
  check_tensor(log_q, "log_q", torch::kFloat32, 3);
  check_same_device(log_s, log_q);
  TORCH_CHECK(log_s.sizes() == log_q.sizes(), "log_s/log_q shape mismatch");
  const int64_t b = log_s.size(0), k = log_s.size(1), n = log_s.size(2);
  TORCH_CHECK(n > 0 && n < INT32_MAX && b * k < INT32_MAX,
              "gls_row_race: unsupported shape");
  check_split_plan("gls_row_race", splits, chunk, n,
                   gls_row_race_max_splits(), 4);
  const c10::cuda::CUDAGuard guard(log_s.device());
  auto rmin = torch::empty({b, k}, log_s.options());
  auto rarg = torch::empty({b, k}, log_s.options().dtype(torch::kInt32));
  if (b * k == 0) return {rmin, rarg};
  check_launch("gls_row_race", launch_gls_row_race(
      log_s.data_ptr<float>(), log_q.data_ptr<float>(),
      rmin.data_ptr<float>(), rarg.data_ptr<int>(), static_cast<int>(b * k),
      static_cast<int>(n), static_cast<int>(splits),
      static_cast<int>(chunk), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {rmin, rarg};
}

std::vector<torch::Tensor> gls_binned_race(torch::Tensor log_s,
                                           torch::Tensor log_q,
                                           torch::Tensor bins,
                                           int64_t l_max) {
  check_tensor(log_s, "log_s", torch::kFloat32, 3);
  check_tensor(log_q, "log_q", torch::kFloat32, 3);
  check_tensor(bins, "bins", torch::kInt32, 2);
  check_same_device(log_s, log_q);
  check_same_device(log_s, bins);
  TORCH_CHECK(log_s.sizes() == log_q.sizes(), "log_s/log_q shape mismatch");
  const int64_t b = log_s.size(0), k = log_s.size(1), n = log_s.size(2);
  TORCH_CHECK(bins.size(0) == b && bins.size(1) == n,
              "bins must be (B, N) of log_s (B, K, N)");
  TORCH_CHECK(l_max >= 1 && l_max <= gls_binned_race_max_bins(),
              "gls_binned_race: l_max " + std::to_string(l_max) +
              " outside [1, " + std::to_string(gls_binned_race_max_bins()) +
              "]");
  TORCH_CHECK(n > 0 && n < INT32_MAX && b * k < INT32_MAX,
              "gls_binned_race: unsupported shape");
  const c10::cuda::CUDAGuard guard(log_s.device());
  auto bmin = torch::empty({b, k, l_max}, log_s.options());
  auto barg = torch::empty({b, k, l_max},
                           log_s.options().dtype(torch::kInt32));
  if (b * k == 0) return {bmin, barg};
  launch_gls_binned_race(log_s.data_ptr<float>(), log_q.data_ptr<float>(),
                         bins.data_ptr<int>(), bmin.data_ptr<float>(),
                         barg.data_ptr<int>(), static_cast<int>(b),
                         static_cast<int>(k), static_cast<int>(n),
                         static_cast<int>(l_max),
                         c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {bmin, barg};
}

using JointLaunch = cudaError_t (*)(const float*, const float*,
                                    const float*, const bool*, int*, int*,
                                    int, int, int, int, cudaStream_t);

// The joint race, or its floor, at `kc` drafts a block.
std::vector<torch::Tensor> joint_race(const char* name, JointLaunch launch,
                                      torch::Tensor log_s,
                                      torch::Tensor log_p,
                                      torch::Tensor log_q,
                                      torch::Tensor active, int64_t kc) {
  const std::string what(name);
  check_tensor(log_s, "log_s", torch::kFloat32, 3);
  check_tensor(log_p, "log_p", torch::kFloat32, 3);
  check_tensor(log_q, "log_q", torch::kFloat32, 3);
  check_tensor(active, "active", torch::kBool, 2);
  check_same_device(log_s, log_p);
  check_same_device(log_s, log_q);
  check_same_device(log_s, active);
  TORCH_CHECK(log_s.sizes() == log_p.sizes() &&
              log_s.sizes() == log_q.sizes(),
              "log_s/log_p/log_q shape mismatch");
  const int64_t b = log_s.size(0), k = log_s.size(1), n = log_s.size(2);
  TORCH_CHECK(active.size(0) == b && active.size(1) == k,
              "active must be (B, K) of log_s (B, K, N)");
  TORCH_CHECK(n > 0 && n < INT32_MAX && b * k < INT32_MAX && k > 0,
              what + ": unsupported shape");
  // The plan (ops.py::joint_race_split_plan): kc drafts a block, one
  // cluster of ceil(K / kc) blocks per row.
  TORCH_CHECK(kc >= 1 && (k + kc - 1) / kc <= gls_race_max_splits(),
              what + ": " + std::to_string(kc) + " drafts a block do not "
              "fit a cluster of " + std::to_string(gls_race_max_splits()) +
              " over " + std::to_string(k) + " drafts");
  const c10::cuda::CUDAGuard guard(log_s.device());
  auto x = torch::empty({b, k}, log_s.options().dtype(torch::kInt32));
  auto y = torch::empty({b}, log_s.options().dtype(torch::kInt32));
  if (b == 0) return {x, y};
  check_launch(name, launch(
      log_s.data_ptr<float>(), log_p.data_ptr<float>(),
      log_q.data_ptr<float>(), active.data_ptr<bool>(), x.data_ptr<int>(),
      y.data_ptr<int>(), static_cast<int>(b), static_cast<int>(k),
      static_cast<int>(n), static_cast<int>(kc),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {x, y};
}

std::vector<torch::Tensor> gls_race(torch::Tensor log_s, torch::Tensor log_p,
                                    torch::Tensor log_q,
                                    torch::Tensor active, int64_t kc) {
  return joint_race("gls_race", launch_gls_race, log_s, log_p, log_q,
                    active, kc);
}

std::vector<torch::Tensor> gls_race_floor(torch::Tensor log_s,
                                          torch::Tensor log_p,
                                          torch::Tensor log_q,
                                          torch::Tensor active, int64_t kc) {
  return joint_race("gls_race_floor", launch_gls_race_floor, log_s, log_p,
                    log_q, active, kc);
}

using DecodeLaunch = cudaError_t (*)(const float*, const float*,
                                     const float*, const int*, float*, int,
                                     int, int, int, int, int, int,
                                     cudaStream_t);

// The float32 decode, or the floor of its group instance (`group_only`:
// a GQA group above 8 at head dim 128), at the split plan (splits,
// chunk).
torch::Tensor decode_f32(const char* name, DecodeLaunch launch,
                         bool group_only, torch::Tensor q, torch::Tensor k,
                         torch::Tensor v, torch::Tensor kv_len,
                         int64_t splits, int64_t chunk) {
  const std::string what(name);
  check_tensor(q, "q", torch::kFloat32, 3);
  check_tensor(k, "k", torch::kFloat32, 4);
  check_tensor(v, "v", torch::kFloat32, 4);
  check_tensor(kv_len, "kv_len", torch::kInt32, 1);
  check_same_device(q, k);
  check_same_device(q, v);
  check_same_device(q, kv_len);
  const int64_t B = q.size(0), H = q.size(1), D = q.size(2);
  const int64_t Hkv = k.size(1), T = k.size(2);
  TORCH_CHECK(k.sizes() == v.sizes(), "k/v shape mismatch");
  TORCH_CHECK(k.size(0) == B && k.size(3) == D, "q/k shape mismatch");
  TORCH_CHECK(kv_len.size(0) == B, "kv_len must be (B,)");
  TORCH_CHECK(Hkv > 0 && H % Hkv == 0, "H must be a multiple of Hkv");
  check_head_dim(name, D,
                 decode_attention_has_head_dim(static_cast<int>(D)));
  const int64_t group = H / Hkv;
  TORCH_CHECK(!group_only || (group > 8 && D == 128),
              what + ": compiled for a GQA group above 8 at head dim 128");
  TORCH_CHECK(B < 65536 && Hkv * decode_group_slots(group) < 65536 &&
                  T < (1 << 24),
              what + ": unsupported shape");
  check_split_plan(name, splits, chunk, T, decode_attention_max_splits(), 1);
  const std::string aligned = what + ": q, k and v";
  check_aligned16(aligned.c_str(), q);
  check_aligned16(aligned.c_str(), k);
  check_aligned16(aligned.c_str(), v);
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  if (B == 0 || H == 0) return out;
  check_launch(name, launch(
      q.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
      kv_len.data_ptr<int>(), out.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(Hkv), static_cast<int>(T),
      static_cast<int>(D), static_cast<int>(splits), static_cast<int>(chunk),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor decode_attention(torch::Tensor q, torch::Tensor k,
                               torch::Tensor v, torch::Tensor kv_len,
                               int64_t splits, int64_t chunk) {
  return decode_f32("decode_attention", launch_decode_attention, false, q,
                    k, v, kv_len, splits, chunk);
}

torch::Tensor decode_attention_group_floor(torch::Tensor q, torch::Tensor k,
                                           torch::Tensor v,
                                           torch::Tensor kv_len,
                                           int64_t splits, int64_t chunk) {
  return decode_f32("decode_attention_group_floor",
                    launch_decode_attention_group_floor, true, q, k, v,
                    kv_len, splits, chunk);
}

using Int8DecodeLaunch = cudaError_t (*)(const float*, const int8_t*,
                                         const int8_t*, const float*,
                                         const float*, const int*, float*,
                                         int, int, int, int, int, int, int,
                                         int, cudaStream_t);

// The int8 decode, or its floor (`floor`: a GQA group above 8 only at head
// dim 128), at the plan (splits, chunk) over `slots` head slots a KV head
// (1 for a group of up to 8; above, each slot at most 48 heads).
torch::Tensor decode_int8(const char* name, Int8DecodeLaunch launch,
                          bool floor, torch::Tensor q, torch::Tensor k,
                          torch::Tensor v, torch::Tensor k_scale,
                          torch::Tensor v_scale, torch::Tensor kv_len,
                          int64_t splits, int64_t chunk, int64_t slots) {
  const std::string what(name);
  check_tensor(q, "q", torch::kFloat32, 3);
  check_tensor(kv_len, "kv_len", torch::kInt32, 1);
  check_int8_kv(name, q, k, v, k_scale, v_scale);
  check_same_device(q, kv_len);
  const int64_t B = q.size(0), H = q.size(1), D = q.size(2);
  const int64_t Hkv = k.size(1), T = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(3) == D, "q/k shape mismatch");
  TORCH_CHECK(kv_len.size(0) == B, "kv_len must be (B,)");
  TORCH_CHECK(Hkv > 0 && H % Hkv == 0, "H must be a multiple of Hkv");
  check_head_dim(name, D,
                 decode_attention_has_head_dim(static_cast<int>(D)));
  const int64_t group = H / Hkv;
  TORCH_CHECK(!floor || group <= 8 || D == 128,
              what + ": compiled for a GQA group above 8 at head dim 128");
  TORCH_CHECK(group > 8 ? slots >= decode_group_slots(static_cast<int>(group))
                              && slots <= group
                        : slots == 1,
              what + ": " + std::to_string(slots) + " head slots do not "
              "hold a group of " + std::to_string(group) + " in slots of at "
              "most 48 heads (1 slot up to 8)");
  TORCH_CHECK(B < 65536 && Hkv * slots < 65536 && T < (1 << 24),
              what + ": unsupported shape");
  check_split_plan(name, splits, chunk, T,
                   decode_attention_max_splits(), 1);
  const std::string aligned = what + ": q, k_scale and v_scale";
  check_aligned16(aligned.c_str(), q);
  check_aligned16(aligned.c_str(), k_scale);
  check_aligned16(aligned.c_str(), v_scale);
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  if (B == 0 || H == 0) return out;
  check_launch(name, launch(
      q.data_ptr<float>(), k.data_ptr<int8_t>(), v.data_ptr<int8_t>(),
      k_scale.data_ptr<float>(), v_scale.data_ptr<float>(),
      kv_len.data_ptr<int>(), out.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(Hkv), static_cast<int>(T),
      static_cast<int>(D), static_cast<int>(splits), static_cast<int>(chunk),
      static_cast<int>(slots), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor decode_attention_int8(torch::Tensor q, torch::Tensor k,
                                    torch::Tensor v, torch::Tensor k_scale,
                                    torch::Tensor v_scale,
                                    torch::Tensor kv_len, int64_t splits,
                                    int64_t chunk, int64_t slots) {
  return decode_int8("decode_attention_int8", launch_decode_attention_int8,
                     false, q, k, v, k_scale, v_scale, kv_len, splits, chunk,
                     slots);
}

torch::Tensor decode_attention_int8_floor(torch::Tensor q, torch::Tensor k,
                                          torch::Tensor v,
                                          torch::Tensor k_scale,
                                          torch::Tensor v_scale,
                                          torch::Tensor kv_len,
                                          int64_t splits, int64_t chunk,
                                          int64_t slots) {
  return decode_int8("decode_attention_int8_floor",
                     launch_decode_attention_int8_floor, true, q, k, v,
                     k_scale, v_scale, kv_len, splits, chunk, slots);
}

torch::Tensor flash_attention(torch::Tensor q, torch::Tensor k,
                              torch::Tensor v, torch::Tensor q_offset,
                              torch::Tensor kv_len, int64_t window,
                              bool causal) {
  check_tensor(q, "q", torch::kFloat32, 4);
  check_tensor(k, "k", torch::kFloat32, 4);
  check_tensor(v, "v", torch::kFloat32, 4);
  check_tensor(q_offset, "q_offset", torch::kInt32, 1);
  check_tensor(kv_len, "kv_len", torch::kInt32, 1);
  check_same_device(q, k);
  check_same_device(q, v);
  check_same_device(q, q_offset);
  check_same_device(q, kv_len);
  const int64_t B = q.size(0), H = q.size(1), S = q.size(2), D = q.size(3);
  const int64_t Hkv = k.size(1), T = k.size(2);
  TORCH_CHECK(k.sizes() == v.sizes(), "k/v shape mismatch");
  TORCH_CHECK(k.size(0) == B && k.size(3) == D, "q/k shape mismatch");
  TORCH_CHECK(q_offset.size(0) == B && kv_len.size(0) == B,
              "q_offset/kv_len must be (B,)");
  TORCH_CHECK(Hkv > 0 && H % Hkv == 0, "H must be a multiple of Hkv");
  TORCH_CHECK(B < 65536 && H < 65536, "flash_attention: grid too large");
  check_head_dim("flash_attention", D,
                 flash_attention_has_head_dim(static_cast<int>(D)));
  TORCH_CHECK(window >= 0, "window must be >= 0");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(q.data_ptr()) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(k.data_ptr()) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(v.data_ptr()) % 16 == 0,
              "flash_attention: q, k and v must be 16-byte aligned");
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  if (B == 0 || H == 0 || S == 0) return out;
  const cudaError_t err = launch_flash_attention(
      q.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
      q_offset.data_ptr<int>(), kv_len.data_ptr<int>(), out.data_ptr<float>(),
      static_cast<int>(B), static_cast<int>(H), static_cast<int>(Hkv),
      static_cast<int>(S), static_cast<int>(T), static_cast<int>(D),
      static_cast<int>(window), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess,
              std::string("flash_attention: setting its shared memory size "
                          "failed: ") + cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor flash_attention_int8(torch::Tensor q, torch::Tensor k,
                                   torch::Tensor v, torch::Tensor k_scale,
                                   torch::Tensor v_scale,
                                   torch::Tensor q_offset,
                                   torch::Tensor kv_len, int64_t window,
                                   bool causal) {
  check_tensor(q, "q", torch::kFloat32, 4);
  check_tensor(q_offset, "q_offset", torch::kInt32, 1);
  check_tensor(kv_len, "kv_len", torch::kInt32, 1);
  check_int8_kv("flash_attention_int8", q, k, v, k_scale, v_scale);
  check_same_device(q, q_offset);
  check_same_device(q, kv_len);
  const int64_t B = q.size(0), H = q.size(1), S = q.size(2), D = q.size(3);
  const int64_t Hkv = k.size(1), T = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(3) == D, "q/k shape mismatch");
  TORCH_CHECK(q_offset.size(0) == B && kv_len.size(0) == B,
              "q_offset/kv_len must be (B,)");
  TORCH_CHECK(Hkv > 0 && H % Hkv == 0, "H must be a multiple of Hkv");
  TORCH_CHECK(B < 65536 && H < 65536, "flash_attention_int8: grid too large");
  check_head_dim("flash_attention_int8", D,
                 flash_attention_has_head_dim(static_cast<int>(D)));
  TORCH_CHECK(window >= 0, "window must be >= 0");
  check_aligned16("flash_attention_int8: q", q);
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  if (B == 0 || H == 0 || S == 0) return out;
  const cudaError_t err = launch_flash_attention_int8(
      q.data_ptr<float>(), k.data_ptr<int8_t>(), v.data_ptr<int8_t>(),
      k_scale.data_ptr<float>(), v_scale.data_ptr<float>(),
      q_offset.data_ptr<int>(), kv_len.data_ptr<int>(), out.data_ptr<float>(),
      static_cast<int>(B), static_cast<int>(H), static_cast<int>(Hkv),
      static_cast<int>(S), static_cast<int>(T), static_cast<int>(D),
      static_cast<int>(window), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess,
              std::string("flash_attention_int8: setting its shared memory "
                          "size failed: ") + cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

std::vector<torch::Tensor> ssd_chunk(torch::Tensor x, torch::Tensor dt,
                                     torch::Tensor a, torch::Tensor b_in,
                                     torch::Tensor c_in) {
  check_tensor(x, "x", torch::kFloat32, 5);
  check_tensor(dt, "dt", torch::kFloat32, 4);
  check_tensor(a, "a", torch::kFloat32, 1);
  check_tensor(b_in, "b_in", torch::kFloat32, 4);
  check_tensor(c_in, "c_in", torch::kFloat32, 4);
  check_same_device(x, dt);
  check_same_device(x, a);
  check_same_device(x, b_in);
  check_same_device(x, c_in);
  const int64_t B = x.size(0), NC = x.size(1), Q = x.size(2), H = x.size(3),
                P = x.size(4), N = b_in.size(3);
  TORCH_CHECK(dt.size(0) == B && dt.size(1) == NC && dt.size(2) == Q &&
              dt.size(3) == H, "dt must be (B, NC, Q, H) of x");
  TORCH_CHECK(a.size(0) == H, "a must be (H,) of x");
  TORCH_CHECK(b_in.sizes() == c_in.sizes(), "b_in/c_in shape mismatch");
  TORCH_CHECK(b_in.size(0) == B && b_in.size(1) == NC && b_in.size(2) == Q,
              "b_in must be (B, NC, Q, N) of x");
  TORCH_CHECK(Q == ssd_chunk_tile_q() && P == ssd_chunk_tile_p() &&
              N == ssd_chunk_tile_n(),
              "ssd_chunk: tile (Q, P, N) = (" + std::to_string(Q) + ", " +
              std::to_string(P) + ", " + std::to_string(N) +
              ") not compiled (only (" +
              std::to_string(ssd_chunk_tile_q()) + ", " +
              std::to_string(ssd_chunk_tile_p()) + ", " +
              std::to_string(ssd_chunk_tile_n()) + "))");
  TORCH_CHECK(B * NC * H < INT32_MAX, "ssd_chunk: unsupported shape");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(b_in.data_ptr()) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(c_in.data_ptr()) % 16 == 0,
              "ssd_chunk: x, b_in and c_in must be 16-byte aligned");
  const c10::cuda::CUDAGuard guard(x.device());
  auto y = torch::empty_like(x);
  auto states = torch::empty({B, NC, H, P, N}, x.options());
  auto total = torch::empty({B, NC, H}, x.options());
  if (B * NC * H == 0) return {y, states, total};
  const cudaError_t err = launch_ssd_chunk(
      x.data_ptr<float>(), dt.data_ptr<float>(), a.data_ptr<float>(),
      b_in.data_ptr<float>(), c_in.data_ptr<float>(), y.data_ptr<float>(),
      states.data_ptr<float>(), total.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(NC), static_cast<int>(H),
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess,
              std::string("ssd_chunk: setting its shared memory size failed: ") +
                  cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {y, states, total};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gls_row_race", &gls_row_race,
        "per-row (min, argmin) of the GLS race table, each row split over "
        "a cluster of `splits` blocks of `chunk` elements");
  m.def("gls_binned_race", &gls_binned_race,
        "per-(row, sheet, bin) (min, argmin) of the binned GLS race");
  m.def("gls_race", &gls_race,
        "draft argmins and the active target argmin of the joint GLS race, "
        "each batch row split over a cluster of blocks of kc drafts");
  m.def("gls_race_floor", &gls_race_floor,
        "the floor of gls_race's design (its grid, clusters and loads, no "
        "compares; x and y zero), for measurement only");
  m.def("ssd_chunk", &ssd_chunk,
        "Mamba-2 SSD intra-chunk output, chunk states and total log-decay");
  m.def("decode_attention", &decode_attention,
        "one-query GQA decode attention over a KV cache, each row's keys "
        "split over a cluster of `splits` blocks of `chunk` keys");
  m.def("decode_attention_group_floor", &decode_attention_group_floor,
        "the floor of decode_attention's instance for a GQA group above 8 "
        "(its grid, clusters, copies and merge, no arithmetic; out zero), "
        "for measurement only");
  m.def("decode_attention_int8", &decode_attention_int8,
        "decode_attention over int8 K/V with per-KV-vector float32 scales, "
        "a GQA group above 8 over `slots` head slots a KV head");
  m.def("decode_attention_int8_floor", &decode_attention_int8_floor,
        "the floor of decode_attention_int8's designs (the G <= 8 instance's "
        "and, at head dim 128, the group instance's: grid, clusters and "
        "data movement, no arithmetic; out zero), for measurement only");
  m.def("flash_attention", &flash_attention,
        "causal or non-causal (optionally windowed) prefill attention with "
        "per-row offsets");
  m.def("flash_attention_int8", &flash_attention_int8,
        "flash_attention over int8 K/V with per-KV-vector float32 scales");
}
