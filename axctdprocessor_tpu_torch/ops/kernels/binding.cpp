// PyTorch binding of the hand-written kernels (tone_ratios.cu, probe.cu,
// chain.cu).
//
// The only file that includes PyTorch's headers, so that nvcc compiles the
// kernels without them.  Each function checks device, dtype, shape and
// contiguity, allocates its outputs, launches on PyTorch's current stream of
// its input's device and raises when the launch is refused.
//
// tone_ratios: ``x`` is one signal (n,) or a batch (rows, n); the outputs are
// (n_win,) or (rows, n_win), and whether the launch streamed the table
// (windows whose table does not fit in shared memory beside the ring; the
// same bits).  Every window of at most 3 strides launches; a longer one is
// refused with a RuntimeError before anything is allocated.  The block
// shape (``warps``, ``wpw``: warps per block, windows per warp) (0, 0) is
// the launcher's choice (the standard shape, or a smaller one for a grid
// under one wave), one of tone_powers_shapes() a shape forced, to compare
// with it: every shape gives the same bits.
//
// tone_powers: the same kernel's raw powers, (n_win, 3) or (rows, n_win, 3),
// of a (n,) or (rows, n) ``x`` whose last dimension is contiguous (rows may
// lie further apart: a view of a wider tensor), at the launcher's shape or
// one forced, as tone_ratios.  Returns the powers and whether the table was
// streamed.  tone_plan(powers, rows, n_win, window, stride) is the launch
// either launcher would make on the current device: (variant "resident" or
// "streamed", warps, windows a warp, blocks, shared-memory bytes, the card's
// opt-in).
//
// probe_at: the (K, 2) or (rows, K, 2) mark and space magnitudes of the
// frames of a (L,) or (rows, L) ``x`` (last dimension contiguous) at the
// int64 ``starts`` of shape (K,) or (rows, K), against the (window, 4) table
// (at most 3072 rows: 48 KB of shared memory beside the staged span), at
// the launcher's geometry for the window (``run`` 0) or one of
// probe_geometries() forced, to compare with it (the same bits).
// probe_geometry(window) is the launcher's (probes a block owns, floats of
// its staged span) for that window, probe_last_launch() the geometry this
// thread's last probe call launched ((0, 0): none).
//
// chain_walk_segments: the bit-edge chain of a (rows, m) int64 successor
// table, returned as the (rows, k) int64 chain; its scratch is one uint8
// tensor of the size the kernel asks for.  chain_walk_frames: frame sync's
// chain of a (rows, m) int64 successor table of stride at most 32, to the
// (rows, k) int64 chain; its look-back flags and tile counter are one int32
// tensor of zeros (one fill), its tiles' records one int32 tensor.  chain_walk:
// the walk of a general map over (n_levels, rows, m) int64 jump tables, to the
// (rows, k) int64 chain.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

extern "C" int axctd_tone_ratios_shape_launch(const float* x, int rows, long long n,
                                              const float* tm, int window, int stride, int n_win,
                                              int warps, int wpw, float* r400, float* r7500,
                                              void* stream);
extern "C" int axctd_tone_powers_launch(const float* x, int rows, long long ld, long long n,
                                        const float* tm, int window, int stride, int n_win,
                                        int warps, int wpw, float* powers, void* stream);
extern "C" int axctd_tone_powers_shapes(int* warps, int* wpw, int cap);
extern "C" int axctd_tone_powers_shape_known(int warps, int wpw);
extern "C" int axctd_tone_plan(int powers, int rows, int n_win, int window, int stride, int warps,
                               int wpw, int* out, long long* blocks);
extern "C" void axctd_probe_plan(int window, int* run, int* span);
extern "C" int axctd_probe_geometries(int* run, int* span, int cap);
extern "C" void axctd_probe_last_launch(int* run, int* span);
extern "C" int axctd_probe_geometry_launch(const float* x, long long ld, long long len, int rows,
                                           const long long* starts, long long k,
                                           const float* tab, int window, int run, int span,
                                           float* out, void* stream);
extern "C" long long axctd_chain_segments_scratch(int rows, long long m, long long start,
                                                  long long k, int sb, int seg, int tpb);
extern "C" int axctd_chain_segments_launch(const long long* nxt, int rows, long long m,
                                           long long start, long long k, int sb, int seg, int tpb,
                                           void* scratch, long long* out, void* stream);
extern "C" long long axctd_chain_frames_tiles(int rows, long long m, long long start, long long k,
                                              int warps, int spw);
extern "C" int axctd_chain_frames_launch(const long long* succ, int rows, long long m,
                                         long long start, long long k, int warps, int spw,
                                         int* flags, void* recs, long long* out, void* stream);
extern "C" int axctd_chain_walk_launch(const long long* levels, int n_levels, int rows,
                                       long long m, int start, long long k, int first,
                                       long long* out, void* stream);
extern "C" void axctd_tone_last_launch(int* out);
extern "C" const char* axctd_cuda_error_string(int code);

constexpr int64_t kMaxSegments = 3;  // tone_ratios.cu: windows of at most 3 strides
constexpr int64_t kMaxFirst = 1024;  // chain.cu: chain heads per block
constexpr int64_t kMaxProbeWindow = 3072;  // probe.cu: the table in 48 KB of shared memory

// The instance this thread's last tone call launched: (segments, powers,
// warps, windows a warp, streamed), all zero if it launched nothing.
std::tuple<int64_t, bool, int64_t, int64_t, bool> tone_last_launch() {
  int out[5] = {0, 0, 0, 0, 0};
  axctd_tone_last_launch(out);
  return {out[0], out[1] != 0, out[2], out[3], out[4] != 0};
}

std::vector<std::tuple<int64_t, int64_t>> tone_powers_shapes() {
  int warps[16], wpw[16];
  const int n = axctd_tone_powers_shapes(warps, wpw, 16);
  TORCH_CHECK(n <= 16, "tone_powers_shapes: more shapes than expected");
  std::vector<std::tuple<int64_t, int64_t>> shapes;
  for (int i = 0; i < n; ++i) shapes.emplace_back(warps[i], wpw[i]);
  return shapes;
}

std::tuple<std::string, int64_t, int64_t, int64_t, int64_t, int64_t> tone_plan(
    bool powers, int64_t rows, int64_t n_win, int64_t window, int64_t stride) {
  TORCH_CHECK(rows > 0 && rows < 65536 && n_win > 0 && n_win < (1LL << 31),
              "tone_plan: rows must be in [1, 65535] and n_win positive");
  TORCH_CHECK(window > 0 && stride > 0 && window < (1LL << 26) &&
                  (window + stride - 1) / stride <= kMaxSegments,
              "tone_plan: window must span at most 3 strides");
  int out[5] = {0, 0, 0, 0, 0};
  long long blocks = 0;
  const int err = axctd_tone_plan(powers ? 1 : 0, static_cast<int>(rows), static_cast<int>(n_win),
                                  static_cast<int>(window), static_cast<int>(stride), 0, 0, out,
                                  &blocks);
  TORCH_CHECK(err == 0, "tone_plan failed: ", axctd_cuda_error_string(err));
  return {out[0] ? "streamed" : "resident", out[1], out[2], blocks, out[3], out[4]};
}

std::tuple<int64_t, int64_t> probe_geometry(int64_t window) {
  TORCH_CHECK(window > 0 && window <= kMaxProbeWindow, "probe_geometry: window in [1, 3072]");
  int run = 0, span = 0;
  axctd_probe_plan(static_cast<int>(window), &run, &span);
  return {run, span};
}

std::vector<std::tuple<int64_t, int64_t>> probe_geometries() {
  int run[16], span[16];
  const int n = axctd_probe_geometries(run, span, 16);
  TORCH_CHECK(n <= 16, "probe_geometries: more geometries than expected");
  std::vector<std::tuple<int64_t, int64_t>> out;
  for (int i = 0; i < n; ++i) out.emplace_back(run[i], span[i]);
  return out;
}

std::tuple<int64_t, int64_t> probe_last_launch() {
  int run = 0, span = 0;
  axctd_probe_last_launch(&run, &span);
  return {run, span};
}

static bool tone_shape_ok(int64_t warps, int64_t wpw) {
  return (warps == 0 && wpw == 0) ||
         (warps > 0 && warps < 64 && wpw > 0 && wpw < 64 &&
          axctd_tone_powers_shape_known(static_cast<int>(warps), static_cast<int>(wpw)));
}

std::tuple<torch::Tensor, torch::Tensor, bool> tone_ratios(torch::Tensor x, torch::Tensor tm,
                                                          int64_t window, int64_t stride,
                                                          int64_t n_win, int64_t warps,
                                                          int64_t wpw) {
  TORCH_CHECK(x.is_cuda() && tm.is_cuda(), "tone_ratios: x and tm must be CUDA tensors");
  TORCH_CHECK(x.device() == tm.device(), "tone_ratios: x and tm on different devices");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32 && tm.scalar_type() == torch::kFloat32,
              "tone_ratios: x and tm must be float32");
  TORCH_CHECK((x.dim() == 1 || x.dim() == 2) && x.is_contiguous(),
              "tone_ratios: x must be a contiguous (n,) or (rows, n) tensor");
  const int64_t rows = x.dim() == 2 ? x.size(0) : 1;
  TORCH_CHECK(rows < 65536, "tone_ratios: at most 65535 rows");
  TORCH_CHECK(tm.dim() == 2 && tm.size(0) == window && tm.size(1) == 6 && tm.is_contiguous(),
              "tone_ratios: tm must be a contiguous (window, 6) table");
  TORCH_CHECK(window > 0 && stride > 0 && window < (1LL << 26) && n_win >= 0 &&
                  n_win < (1LL << 31),
              "tone_ratios: bad window/stride/n_win");
  TORCH_CHECK((window + stride - 1) / stride <= kMaxSegments,
              "tone_ratios: window must span at most 3 strides");
  TORCH_CHECK(tone_shape_ok(warps, wpw),
              "tone_ratios: the block shape (warps, wpw) must be (0, 0), the launcher's choice, "
              "or one of tone_powers_shapes()");
  // the kernel copies the table in 16-byte pieces
  if (reinterpret_cast<uintptr_t>(tm.data_ptr()) % 16 != 0) tm = tm.clone();
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<int64_t> shape = {2, n_win};  // (r400, r7500) in one allocation
  if (x.dim() == 2) shape.insert(shape.begin() + 1, rows);
  auto out = torch::empty(shape, x.options());
  const int err = axctd_tone_ratios_shape_launch(
      x.data_ptr<float>(), static_cast<int>(rows), x.size(-1), tm.data_ptr<float>(),
      static_cast<int>(window), static_cast<int>(stride), static_cast<int>(n_win),
      static_cast<int>(warps), static_cast<int>(wpw), out[0].data_ptr<float>(),
      out[1].data_ptr<float>(), at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "tone_ratios launch failed: ", axctd_cuda_error_string(err));
  return {out[0], out[1], std::get<4>(tone_last_launch())};
}

static void check_tone_args(const torch::Tensor& x, torch::Tensor& tm, int64_t window,
                            int64_t stride, int64_t n_win, const char* name) {
  TORCH_CHECK(x.is_cuda() && tm.is_cuda(), name, ": x and tm must be CUDA tensors");
  TORCH_CHECK(x.device() == tm.device(), name, ": x and tm on different devices");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32 && tm.scalar_type() == torch::kFloat32,
              name, ": x and tm must be float32");
  TORCH_CHECK(tm.dim() == 2 && tm.size(0) == window && tm.size(1) == 6 && tm.is_contiguous(),
              name, ": tm must be a contiguous (window, 6) table");
  TORCH_CHECK(window > 0 && stride > 0 && window < (1LL << 26) && n_win >= 0 &&
                  n_win < (1LL << 31),
              name, ": bad window/stride/n_win");
  TORCH_CHECK((window + stride - 1) / stride <= kMaxSegments,
              name, ": window must span at most 3 strides");
  // the kernel copies the table in 16-byte pieces
  if (reinterpret_cast<uintptr_t>(tm.data_ptr()) % 16 != 0) tm = tm.clone();
}

std::tuple<torch::Tensor, bool> tone_powers(torch::Tensor x, torch::Tensor tm, int64_t window,
                                            int64_t stride, int64_t n_win, int64_t warps,
                                            int64_t wpw) {
  check_tone_args(x, tm, window, stride, n_win, "tone_powers");
  TORCH_CHECK(tone_shape_ok(warps, wpw),
              "tone_powers: the block shape (warps, wpw) must be (0, 0), the launcher's choice, "
              "or one of tone_powers_shapes()");
  TORCH_CHECK((x.dim() == 1 || x.dim() == 2) && x.stride(-1) == 1 &&
                  (x.dim() == 1 || x.size(0) <= 1 || x.stride(0) >= x.size(1)),
              "tone_powers: x must be (n,) or (rows, n) with its last dimension contiguous");
  const int64_t rows = x.dim() == 2 ? x.size(0) : 1;
  TORCH_CHECK(rows < 65536, "tone_powers: at most 65535 rows");
  const int64_t ld = x.dim() == 2 && rows > 1 ? x.stride(0) : x.size(-1);
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<int64_t> shape = {n_win, 3};
  if (x.dim() == 2) shape.insert(shape.begin(), rows);
  auto out = torch::empty(shape, x.options());
  const int err = axctd_tone_powers_launch(
      x.data_ptr<float>(), static_cast<int>(rows), ld, x.size(-1), tm.data_ptr<float>(),
      static_cast<int>(window), static_cast<int>(stride), static_cast<int>(n_win),
      static_cast<int>(warps), static_cast<int>(wpw), out.data_ptr<float>(),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "tone_powers launch failed: ", axctd_cuda_error_string(err));
  return {out, std::get<4>(tone_last_launch())};
}

torch::Tensor probe_at(torch::Tensor x, torch::Tensor starts, torch::Tensor tab, int64_t run,
                       int64_t span) {
  TORCH_CHECK(x.is_cuda() && starts.is_cuda() && tab.is_cuda(),
              "probe_at: x, starts and tab must be CUDA tensors");
  TORCH_CHECK(x.device() == starts.device() && x.device() == tab.device(),
              "probe_at: x, starts and tab on different devices");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32 && tab.scalar_type() == torch::kFloat32 &&
                  starts.scalar_type() == torch::kInt64,
              "probe_at: x and tab must be float32, starts int64");
  TORCH_CHECK((x.dim() == 1 || x.dim() == 2) && x.stride(-1) == 1 &&
                  (x.dim() == 1 || x.size(0) <= 1 || x.stride(0) >= x.size(1)),
              "probe_at: x must be (L,) or (rows, L) with its last dimension contiguous");
  TORCH_CHECK(starts.dim() == x.dim() && starts.is_contiguous() &&
                  (x.dim() == 1 || starts.size(0) == x.size(0)),
              "probe_at: starts must be a contiguous (K,) or (rows, K) tensor matching x");
  const int64_t window = tab.size(0);
  TORCH_CHECK(tab.dim() == 2 && tab.size(1) == 4 && tab.is_contiguous() && window > 0 &&
                  window <= kMaxProbeWindow,
              "probe_at: tab must be a contiguous (window, 4) table, window at most 3072");
  TORCH_CHECK(x.size(-1) >= window, "probe_at: rows shorter than the window");
  const int64_t rows = x.dim() == 2 ? x.size(0) : 1;
  TORCH_CHECK(rows < (1LL << 31), "probe_at: too many rows");
  bool known = run == 0 && span == 0;  // the launcher's choice, or one it has
  if (!known)
    for (const auto& g : probe_geometries())
      known = known || (std::get<0>(g) == run && std::get<1>(g) == span);
  TORCH_CHECK(known, "probe_at: the geometry (run, span) must be (0, 0), the launcher's choice, "
              "or one of probe_geometries()");
  const int64_t ld = x.dim() == 2 && rows > 1 ? x.stride(0) : x.size(-1);
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<int64_t> shape = starts.sizes().vec();
  shape.push_back(2);
  auto out = torch::empty(shape, x.options());
  const int err = axctd_probe_geometry_launch(
      x.data_ptr<float>(), ld, x.size(-1), static_cast<int>(rows),
      reinterpret_cast<const long long*>(starts.data_ptr<int64_t>()), starts.size(-1),
      tab.data_ptr<float>(), static_cast<int>(window), static_cast<int>(run),
      static_cast<int>(span), out.data_ptr<float>(), at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "probe_at launch failed: ", axctd_cuda_error_string(err));
  return out;
}

torch::Tensor chain_walk_segments(torch::Tensor nxt, int64_t start, int64_t k,
                                  int64_t stride_bound, int64_t seg, int64_t tpb) {
  TORCH_CHECK(nxt.is_cuda() && nxt.scalar_type() == torch::kInt64,
              "chain_walk_segments: nxt must be a CUDA int64 tensor");
  TORCH_CHECK(nxt.dim() == 2 && nxt.is_contiguous(),
              "chain_walk_segments: nxt must be a contiguous (rows, m) tensor");
  const int64_t rows = nxt.size(0), m = nxt.size(1);
  const long long bytes = axctd_chain_segments_scratch(
      static_cast<int>(std::min<int64_t>(rows, 65536)), m, start, k,
      static_cast<int>(stride_bound), static_cast<int>(seg), static_cast<int>(tpb));
  TORCH_CHECK(bytes >= 0, "chain_walk_segments: bad shape or arguments (rows ", rows, ", m ", m,
              ", start ", start, ", k ", k, ", stride_bound ", stride_bound, ", seg ", seg,
              ", tpb ", tpb, ")");
  const c10::cuda::CUDAGuard guard(nxt.device());
  auto out = torch::empty({rows, k}, nxt.options());
  auto scratch = torch::empty({bytes}, nxt.options().dtype(torch::kUInt8));
  const int err = axctd_chain_segments_launch(
      reinterpret_cast<const long long*>(nxt.data_ptr<int64_t>()), static_cast<int>(rows), m,
      start, k, static_cast<int>(stride_bound), static_cast<int>(seg), static_cast<int>(tpb),
      scratch.data_ptr(), reinterpret_cast<long long*>(out.data_ptr<int64_t>()),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "chain_walk_segments launch failed: ", axctd_cuda_error_string(err));
  return out;
}

torch::Tensor chain_walk_frames(torch::Tensor succ, int64_t start, int64_t k, int64_t warps,
                                int64_t spw) {
  TORCH_CHECK(succ.is_cuda() && succ.scalar_type() == torch::kInt64,
              "chain_walk_frames: succ must be a CUDA int64 tensor");
  TORCH_CHECK(succ.dim() == 2 && succ.is_contiguous(),
              "chain_walk_frames: succ must be a contiguous (rows, m) tensor");
  const int64_t rows = succ.size(0), m = succ.size(1);
  const long long tiles = rows < (1LL << 31)
      ? axctd_chain_frames_tiles(static_cast<int>(rows), m, start, k, static_cast<int>(warps),
                                 static_cast<int>(spw))
      : -1;
  TORCH_CHECK(tiles >= 0, "chain_walk_frames: bad shape or arguments (rows ", rows, ", m ", m,
              ", start ", start, ", k ", k, ", warps ", warps, ", spw ", spw, ")");
  const c10::cuda::CUDAGuard guard(succ.device());
  auto out = torch::empty({rows, k}, succ.options());
  auto flags = torch::zeros({tiles + 1}, succ.options().dtype(torch::kInt32));
  auto recs = torch::empty({tiles * 33 * 2}, succ.options().dtype(torch::kInt32));
  const int err = axctd_chain_frames_launch(
      reinterpret_cast<const long long*>(succ.data_ptr<int64_t>()), static_cast<int>(rows), m,
      start, k, static_cast<int>(warps), static_cast<int>(spw), flags.data_ptr<int32_t>(),
      recs.data_ptr(), reinterpret_cast<long long*>(out.data_ptr<int64_t>()),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "chain_walk_frames launch failed: ", axctd_cuda_error_string(err));
  return out;
}

static void check_walk(const torch::Tensor& levels, c10::ScalarType dtype, int64_t start,
                       int64_t k, int64_t first, const char* name) {
  TORCH_CHECK(levels.is_cuda(), name, ": levels must be a CUDA tensor");
  TORCH_CHECK(levels.scalar_type() == dtype, name, ": levels has the wrong dtype");
  TORCH_CHECK(levels.dim() == 3 && levels.is_contiguous(),
              name, ": levels must be a contiguous (n_levels, rows, m) tensor");
  TORCH_CHECK(levels.size(1) < (1LL << 31) && levels.size(2) < (1LL << 31),
              name, ": table too large");
  TORCH_CHECK(first >= 1 && first <= kMaxFirst && (first & (first - 1)) == 0,
              name, ": first must be a power of two up to 1024");
  int64_t need = 0;  // the doubling reads log2(first) levels, the tail one more
  while ((int64_t{1} << need) < first) ++need;
  if (k > first) ++need;
  TORCH_CHECK(levels.size(0) >= std::max<int64_t>(need, 1), name, ": too few levels");
  TORCH_CHECK(k >= 0 && start >= 0 && start < std::max<int64_t>(levels.size(2), 1),
              name, ": bad start/k");
}

torch::Tensor chain_walk(torch::Tensor levels, int64_t start, int64_t k, int64_t first) {
  check_walk(levels, torch::kInt64, start, k, first, "chain_walk");
  const c10::cuda::CUDAGuard guard(levels.device());
  auto out = torch::empty({levels.size(1), k}, levels.options());
  const int err = axctd_chain_walk_launch(
      reinterpret_cast<const long long*>(levels.data_ptr<int64_t>()),
      static_cast<int>(levels.size(0)), static_cast<int>(levels.size(1)), levels.size(2),
      static_cast<int>(start), k, static_cast<int>(first),
      reinterpret_cast<long long*>(out.data_ptr<int64_t>()),
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "chain_walk launch failed: ", axctd_cuda_error_string(err));
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  using pybind11::arg;
  m.def("tone_ratios", &tone_ratios,
        "Fused tone powers, box mean and log10 ratios (CUDA), and whether the table streamed",
        arg("x"), arg("tm"), arg("window"), arg("stride"), arg("n_win"), arg("warps") = 0,
        arg("wpw") = 0);
  m.def("tone_powers", &tone_powers,
        "Raw tone powers of every strided window (CUDA), and whether the table streamed");
  m.def("tone_powers_shapes", &tone_powers_shapes,
        "The block shapes (warps, windows per warp) either tone launch may take, the standard "
        "first");
  m.def("tone_plan", &tone_plan,
        "The tone launch for (powers, rows, n_win, window, stride) on the current device: "
        "(variant, warps, windows a warp, blocks, shared-memory bytes, the card's opt-in)");
  m.def("tone_last_launch", &tone_last_launch,
        "The instance this thread's last tone_ratios or tone_powers call launched: (segments, "
        "powers, warps, windows a warp, streamed), all zero if it launched nothing");
  m.def("probe_at", &probe_at, "Mark and space magnitudes of frames at given starts (CUDA)",
        arg("x"), arg("starts"), arg("tab"), arg("run") = 0, arg("span") = 0);
  m.def("probe_geometry", &probe_geometry,
        "probe_at's run (probes a block owns) and staged span (floats) for a window");
  m.def("probe_geometries", &probe_geometries,
        "The geometries (run, span) probe_at may take, the standard first");
  m.def("probe_last_launch", &probe_last_launch,
        "The geometry (run, span) this thread's last probe_at call launched, (0, 0) if none");
  m.def("chain_walk_segments", &chain_walk_segments,
        "Bit-edge chain of a bounded-stride successor table by a segment-parallel walk (CUDA)");
  m.def("chain_walk_frames", &chain_walk_frames,
        "Frame sync's chain of a successor table of stride <= 32, one pass with look-back (CUDA)");
  m.def("chain_walk", &chain_walk, "Chain walk over full jump tables (CUDA)");
}
