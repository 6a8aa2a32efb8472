// The launch log: every kernel launch of the library notes its kernel's
// host address here, so that a caller learns which kernel a C entry
// picked without a profiler. wmz_launch_log (launch_log.cu) reads the
// names back; wmz_launch_log_reset clears the log.
#pragma once

namespace wmz {

void note_launch_address(const void* kernel);

// `kernel` is the __global__ function (or its address) about to launch.
template <typename K>
inline void note_launch(K* kernel) {
  note_launch_address(reinterpret_cast<const void*>(kernel));
}
inline void note_launch(const void* kernel) { note_launch_address(kernel); }

}  // namespace wmz
