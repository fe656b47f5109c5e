// A device-side while loop for the port's optimizer loops: one CUDA graph
// that runs
//
//     pre();  do { body(); } while (!*flag);  post();
//
// with no read to the host, the counterpart of the JAX package's
// `lax.while_loop` inside a jitted `lax.scan` (optax's zoom line search
// inside L-BFGS, event_based_bos_tpu/optim.py::run_lbfgs).  It ports no
// Pallas kernel: the TPU program keeps its loop on the device through XLA's
// control flow, and this source gives the card the same.
//
// The three parts are graphs captured by PyTorch (torch.cuda.CUDAGraph with
// keep_graph=True, so their cudaGraph_t stays readable).  ebt_while_build
// assembles the parent graph once:
//
//   * a child-graph node holding `pre`;
//   * a conditional WHILE node (cudaGraphCondTypeWhile) after it, whose
//     handle is created on the parent graph with default value 1 and
//     cudaGraphCondAssignDefault, so that every launch enters the body at
//     least once;
//   * in the WHILE node's body graph: a child-graph node holding `body`,
//     then one node of `while_condition_kernel`, one thread, which reads
//     the flag that `body` wrote and sets the handle to !flag
//     (cudaGraphSetConditional); it also adds one to a device counter of
//     its own launches, which the host reads only when it asks;
//   * a child-graph node holding `post` after the WHILE node.
//
// The parent graph is instantiated once; ebt_while_launch launches it on a
// stream.  Adding a child-graph node clones the graph it is given, but the
// clones read and write the memory the captured parts were given (their
// buffers and their memory pool), which the caller keeps alive until
// ebt_while_destroy has destroyed the executable graph and the parent.
//
// What bounds it on an H100: the condition kernel reads one byte and
// read-modify-writes one 8-byte counter a trial; its time is the node's
// launch, not memory (PERF.md: chip_smoke.py phase 17 times a trial of an
// empty body against the same trial driven from the host).

#include <cuda_runtime.h>

namespace {

__global__ void while_condition_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* flag,
                                       unsigned long long* launches) {
  cudaGraphSetConditional(handle, *flag ? 0u : 1u);
  *launches += 1ull;
}

struct WhileGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

int fail(WhileGraph* g, cudaError_t err) {
  if (g->exec) cudaGraphExecDestroy(g->exec);
  if (g->graph) cudaGraphDestroy(g->graph);
  delete g;
  return static_cast<int>(err);
}

}  // namespace

#define EBT_TRY(call)                  \
  do {                                 \
    cudaError_t err_ = (call);         \
    if (err_ != cudaSuccess) {         \
      return fail(g, err_);            \
    }                                  \
  } while (0)

// Builds and instantiates the parent graph of three captured graphs (raw
// cudaGraph_t handles) around the device flag `flag` (one byte, nonzero =
// stop) and the launch counter `launches`; writes an opaque handle to
// *out.  Returns a cudaError_t (0 on success).
extern "C" int ebt_while_build(void* pre, void* body, void* post,
                               const unsigned char* flag,
                               unsigned long long* launches, void** out) {
  *out = nullptr;
  WhileGraph* g = new WhileGraph();
  EBT_TRY(cudaGraphCreate(&g->graph, 0));

  cudaGraphNode_t pre_node, cond_node, body_node, kernel_node, post_node;
  EBT_TRY(cudaGraphAddChildGraphNode(&pre_node, g->graph, nullptr, 0,
                                     static_cast<cudaGraph_t>(pre)));

  cudaGraphConditionalHandle handle;
  EBT_TRY(cudaGraphConditionalHandleCreate(&handle, g->graph, 1u,
                                           cudaGraphCondAssignDefault));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  EBT_TRY(cudaGraphAddNode(&cond_node, g->graph, &pre_node, 1, &params));
  cudaGraph_t loop = params.conditional.phGraph_out[0];

  EBT_TRY(cudaGraphAddChildGraphNode(&body_node, loop, nullptr, 0,
                                     static_cast<cudaGraph_t>(body)));
  void* args[] = {&handle, &flag, &launches};
  cudaKernelNodeParams kernel = {};
  kernel.func = reinterpret_cast<void*>(while_condition_kernel);
  kernel.gridDim = dim3(1);
  kernel.blockDim = dim3(1);
  kernel.sharedMemBytes = 0;
  kernel.kernelParams = args;
  kernel.extra = nullptr;
  EBT_TRY(cudaGraphAddKernelNode(&kernel_node, loop, &body_node, 1, &kernel));

  EBT_TRY(cudaGraphAddChildGraphNode(&post_node, g->graph, &cond_node, 1,
                                     static_cast<cudaGraph_t>(post)));
  EBT_TRY(cudaGraphInstantiate(&g->exec, g->graph, 0));
  *out = g;
  return 0;
}

#undef EBT_TRY

// One launch of the parent graph on `stream`.
extern "C" int ebt_while_launch(void* handle, void* stream) {
  WhileGraph* g = static_cast<WhileGraph*>(handle);
  return static_cast<int>(
      cudaGraphLaunch(g->exec, static_cast<cudaStream_t>(stream)));
}

// Destroys the executable graph, then the parent graph.
extern "C" int ebt_while_destroy(void* handle) {
  WhileGraph* g = static_cast<WhileGraph*>(handle);
  cudaError_t a = cudaGraphExecDestroy(g->exec);
  cudaError_t b = cudaGraphDestroy(g->graph);
  delete g;
  return static_cast<int>(a != cudaSuccess ? a : b);
}
