// PyTorch binding of the tone-ratio kernel (tone_ratios.cu).
//
// The only file that includes PyTorch's headers, so that nvcc compiles the
// kernel without them.  Checks device, dtype, shape and contiguity, allocates
// the outputs, launches on the stream the caller passes (PyTorch's current
// stream) and raises when the launch is refused.  ``x`` is one signal (n,)
// or a batch (rows, n); the outputs are (n_win,) or (rows, n_win).

#include <torch/extension.h>

extern "C" int axctd_tone_ratios_launch(const float* x, int rows, long long n,
                                        const float* tm, int window,
                                        int stride, int n_win, float* r400,
                                        float* r7500, void* stream);
extern "C" const char* axctd_cuda_error_string(int code);

std::vector<torch::Tensor> tone_ratios(torch::Tensor x, torch::Tensor tm,
                                       int64_t window, int64_t stride,
                                       int64_t n_win, int64_t stream) {
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
  TORCH_CHECK(window > 0 && stride > 0 && n_win >= 0 && n_win < (1LL << 31),
              "tone_ratios: bad window/stride/n_win");
  std::vector<int64_t> shape = {n_win};
  if (x.dim() == 2) shape.insert(shape.begin(), rows);
  auto r400 = torch::empty(shape, x.options());
  auto r7500 = torch::empty(shape, x.options());
  const int err = axctd_tone_ratios_launch(
      x.data_ptr<float>(), static_cast<int>(rows), x.size(-1), tm.data_ptr<float>(),
      static_cast<int>(window), static_cast<int>(stride), static_cast<int>(n_win),
      r400.data_ptr<float>(), r7500.data_ptr<float>(),
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "tone_ratios launch failed: ", axctd_cuda_error_string(err));
  return {r400, r7500};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("tone_ratios", &tone_ratios, "Fused tone powers, box mean and log10 ratios (CUDA)");
}
