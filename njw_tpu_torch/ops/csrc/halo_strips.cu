// Strided strip copies: the pack and unpack of the sharded steppers' halo
// exchange (njw_tpu_torch/parallel/mesh.py _PairExchange packs,
// parallel/halo.py _Fill unpacks), for sm_90a.
//
// Replaces no TPU kernel. In the JAX package a sharded step's halo bands
// are sliced and concatenated by XLA around lax.ppermute inside
// shard_map, and XLA fuses those copies into the step. Here the bands are
// strips of padded blocks: a column strip (L, ly, 1) with the block's
// row pitch, a row strip (L, 1, lx) with its plane pitch. PyTorch's
// _foreach_copy_ takes its fused path only for dense tensors of one shape
// and stride, so it copied such strips one kernel each: 40 launches a
// stage on a 2 x 2 mesh of config 5, about 0.7 ms of an 8 ms step on an
// H100.
//
// One launch copies a list of up to kMaxStrips strips. Strip k is a box of
// (planes, rows, cols) float32 at src with plane and row pitches, written
// to dst with its own pitches; columns are consecutive on both sides. The
// refresh packs its strips into the collective's send buffer (dst pitches
// those of a contiguous box), and unpacks the receive buffer into the
// bands (src contiguous); on a mesh held by one process the unpack reads
// the neighbours' strips directly. The list is one __grid_constant__
// parameter, built once per arrangement of the buffers by the wrapper
// (ops/halo_strips.py), so a launch costs the host one ctypes call.
//
// Bound on this card: memory. Each element is read once and written once,
// 8 B a point: a config-5 stage on a 2 x 2 mesh packs, an axis a launch,
// 2 x 5 column strips of 1024 rows (40 planes, ps one), then 2 x 5 row
// strips of 1026 columns, 1.3 MB each, under a microsecond at 3.35 TB/s.
// A column strip reads one float from each 32-byte sector (and writes one
// into each on unpack), so its side moves 8 x its bytes: ~10 MB a launch,
// ~3 us. What decides the time is then latency and how many loads are in
// flight, and a launch's fixed cost.
//
// Design against that: a strip's elements are numbered column fastest,
// then row, then plane, and cut into chunks of kChunk (1024) elements; a
// block of kThreads (256) takes one chunk, each thread four elements
// kThreads apart, issuing its four loads before any store. A row strip's
// neighbouring threads thus read and write neighbouring columns (whole
// rows, coalesced); a column strip is spread over its planes and rows,
// 1024 rows a block, so each config-5 pack above is ~330 blocks and
// every SM has work. A block finds its strip by a binary search over the
// strips' first chunks, read from the parameter space (the same for every
// thread of the block). No shared memory and no barrier.

#include <cuda_runtime.h>

constexpr int kMaxStrips = 80;   // 8 + 80 x 48 B of parameters, < 4 KiB

struct Strip {
    const float* src;
    float* dst;
    int src_plane, src_row;      // pitches, elements
    int dst_plane, dst_row;
    int planes, rows, cols;      // planes * rows * cols < 2^31
    int first;                   // the strip's first chunk
};

struct Strips {
    int n;                       // strips, 1..kMaxStrips
    int chunks;                  // chunks of every strip: the grid
    Strip s[kMaxStrips];
};

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
halo_strips_kernel(const __grid_constant__ Strips t) {
    const int b = static_cast<int>(blockIdx.x);
    int lo = 0, hi = t.n - 1;
    while (lo < hi) {            // the last strip whose first chunk <= b
        const int mid = (lo + hi + 1) >> 1;
        if (t.s[mid].first <= b) {
            lo = mid;
        } else {
            hi = mid - 1;
        }
    }
    const Strip& s = t.s[lo];
    const unsigned cols = static_cast<unsigned>(s.cols);
    const unsigned rows = static_cast<unsigned>(s.rows);
    const unsigned n = static_cast<unsigned>(s.planes) * rows * cols;
    const unsigned i0 = static_cast<unsigned>(b - s.first) * kChunk
                        + threadIdx.x;
    float v[kPerThread];
    long long to[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        const unsigned i = i0 + j * kThreads;
        if (i < n) {
            const unsigned c = i % cols, pr = i / cols;
            const long long r = pr % rows, p = pr / rows;
            v[j] = s.src[p * s.src_plane + r * s.src_row + c];
            to[j] = p * s.dst_plane + r * s.dst_row + c;
        }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        if (i0 + j * kThreads < n) s.dst[to[j]] = v[j];
    }
}

}  // namespace

// Launch the copies of the list *t on `stream`; returns the CUDA error
// code (cudaErrorInvalidValue for a list the kernel does not take).
extern "C" int halo_strips_launch(const Strips* t, void* stream) {
    if (t->n < 1 || t->n > kMaxStrips || t->chunks < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    halo_strips_kernel<<<t->chunks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*t);
    return static_cast<int>(cudaGetLastError());
}

// The layout the wrapper mirrors: kMaxStrips, kChunk, sizeof(Strip),
// sizeof(Strips) into out[4].
extern "C" int halo_strips_layout(int* out) {
    out[0] = kMaxStrips;
    out[1] = kChunk;
    out[2] = static_cast<int>(sizeof(Strip));
    out[3] = static_cast<int>(sizeof(Strips));
    return 0;
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* halo_strips_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
