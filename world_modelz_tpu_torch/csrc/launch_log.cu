// The launch log (launch_log.cuh): the kernels the library launched since
// the last wmz_launch_log_reset, by name. Noting a launch is one relaxed
// atomic add and one store; the names are looked up only when read
// (cudaFuncGetName, CUDA 12.3 or later, demangled by the C++ runtime).

#include <cuda_runtime.h>
#include <cxxabi.h>

#include <atomic>
#include <cstdlib>
#include <cstring>

#include "launch_log.cuh"

namespace {

constexpr int kLogged = 256;  // launches named (_build.LOGGED); later ones are only counted
std::atomic<int> g_launches{0};
std::atomic<const void*> g_kernels[kLogged];

}  // namespace

void wmz::note_launch_address(const void* kernel) {
  const int i = g_launches.fetch_add(1, std::memory_order_relaxed);
  if (i < kLogged) g_kernels[i].store(kernel, std::memory_order_relaxed);
}

extern "C" void wmz_launch_log_reset() { g_launches.store(0); }

// The first kLogged kernels launched since the reset, in order, one
// demangled name a line, into buf (cap bytes, NUL-terminated). Returns
// the number of launches since the reset, or -1 when a name cannot be
// read or buf is too small.
extern "C" int wmz_launch_log(char* buf, int cap) {
  if (cap < 1) return -1;
  const int n = g_launches.load();
  int used = 0;
  buf[0] = '\0';
  for (int i = 0; i < n && i < kLogged; ++i) {
    const char* mangled = nullptr;
    if (cudaFuncGetName(&mangled, g_kernels[i].load()) != cudaSuccess || !mangled) return -1;
    int status = 0;
    char* name = abi::__cxa_demangle(mangled, nullptr, nullptr, &status);
    const char* text = status == 0 ? name : mangled;
    const int len = (int)strlen(text);
    const bool fits = used + len + 2 <= cap;
    if (fits) {
      memcpy(buf + used, text, len);
      used += len;
      buf[used++] = '\n';
      buf[used] = '\0';
    }
    free(name);
    if (!fits) return -1;
  }
  return n;
}
