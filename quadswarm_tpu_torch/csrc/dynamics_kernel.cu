// Fused quadrotor dynamics: one control tick (sim_steps rigid-body
// sub-steps) for every drone of a flat batch, one thread per drone.
//
// Replaces the TPU kernel quadswarm_tpu/ops/pallas/dynamics_kernel.py::
// _dynamics_kernel.  Its plain PyTorch version is
// quadswarm_tpu_torch/env/dynamics.py::dynamics_tick, which this kernel
// follows operation for operation (atan2f / sincosf where the plain
// version uses atan2 / cos / sin).
//
// What bounds it here: the work is elementwise and small.  Each drone reads
// 145 bytes (state, thrust commands, the tick's OU noise and crash yaw) and
// writes 160 bytes, about 305 bytes per drone per tick, and does roughly
// 600 float operations for two sub-steps.  At 8,192 drones (1024 envs x 8)
// that is 2.5 MB, under 1 us of HBM time at 3.35 TB/s.  What the kernel
// takes is latency: the launch (about 1.2 us for an empty kernel of its
// grid), one round trip to memory, and one thread's chain of dependent
// sincosf, sqrtf, IEEE divisions and atan2f, which no other warp can hide
// while an SM holds two or three warps.  So every instruction outside that
// chain counts, and the block size hardly does (32, 64 and 128 threads a
// block measured within 3% of each other at 8,192 and at 32,768 drones; 64
// gives 128 blocks at 8,192 drones, about one per SM).
//
// The design, one thread per drone with every intermediate in registers:
//  - Inputs straight from device memory into registers, every load sent
//    before the first use: the (B, 4) fields as one float4 per drone, the
//    (B, 3) and (B, 3, 3) fields at their strides of 3 and 9 floats.  The
//    inputs sit in L2 (the tick before wrote them), and staging them
//    through shared memory (cp.async) measured slower on an H100 at 8,192
//    drones and no faster at 32,768, so they are not staged.
//  - Outputs of the (B, 3) and (B, 3, 3) fields staged through shared
//    memory: each thread writes its drone at strides 3 and 9 (odd, so free
//    of bank conflicts), the block synchronises, and its slab of each
//    field, contiguous in device memory, goes out as float4 stores,
//    neighbouring threads on neighbouring 16 bytes.  Strided stores
//    straight from registers measured half again as slow at 32,768 drones.
//    The block size is a compile-time constant, so a full block's copy is
//    ten predicated load-store pairs a thread with no loop: with a loop per
//    field the epilogue cost more at 8,192 drones than the coalescing
//    saved.  The ragged last block takes loops with a scalar tail.  The two
//    (B, 4) outputs are one float4 store per drone.
//  - Every 16-byte access relies on alignment that the wrapper guarantees:
//    it allocates the float arena itself and refuses a (B, 4) input whose
//    address is no multiple of 16.
//  - Outputs in three arenas (float32, bool, int32) that the wrapper
//    allocates: the kernel takes the three base pointers and derives every
//    field's offset from B, each float field starting on a 16-byte boundary
//    (the layout of ops/kernels/dynamics_kernel.py::arena_layout).
//  - Fields keep their natural row-major layouts (no packing into planes,
//    which on this card would be two extra passes over the same bytes); the
//    44 shared parameters travel by value in the launch arguments.
//  - Per-drone parameters (a randomized fleet, which the TPU kernel never
//    receives: the JAX package integrates such fleets with XLA) come as a
//    (rows, N_PARAMS) float32 table in device memory, and drone b reads row
//    b % rows: the batch is env-major, so row i is drone i of every env.
//    A template flag picks the form at compile time, so the shared form's
//    code and its by-value launch are the same as without the table.  The
//    table is at most a few KB and every block reads the same rows, so
//    after the first block it is served from L1/L2: 176 bytes a drone more
//    to read from cache, not from device memory at rows << B.
//
// Precision: IEEE sqrtf and division (no --use_fast_math); nvcc's default
// FMA contraction is accepted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kGrav = 9.81f;
constexpr float kEps = 1e-6f;

// Parameter vector layout, shared with ops/kernels/dynamics_kernel.py.
enum {
  P_DT = 0, P_MU = 1, P_OMEGA_MAX = 2, P_FLOOR_THR = 3, P_GRAV = 4,
  P_VEL_DAMP = 5, P_LINEARITY = 6, P_TAU_UP = 7, P_TAU_DOWN = 8, P_MASS = 9,
  P_INERTIA = 10,        // 3
  P_DAMP_OMEGA_Q = 13,
  P_THRUST_MAX = 14,     // 4
  P_TORQUE_MAX = 18,     // 4
  P_PROP_CROSS = 22,     // 12, motor-major
  P_PROP_CCW = 34,       // 4
  P_ROOM_LO = 38,        // 3
  P_ROOM_HI = 41,        // 3
  N_PARAMS = 44
};

struct Params {
  float v[N_PARAMS];
};

// Inputs by field; outputs as the three arenas (see arena offsets below).
struct Io {
  const float* pos; const float* vel; const float* rot; const float* omega;
  const float* cmds_damp; const float* rot_damp; const bool* on_floor;
  const int32_t* step_count; const float* thrust_cmds; const float* ou;
  const float* yaw;
  float* out_f; bool* out_b; int32_t* out_i;
};

// Output arena layout, shared with ops/kernels/dynamics_kernel.py::
// arena_layout.  Float arena: pos, vel, omega, acc, accelerometer,
// omega_dot, torque (3 floats per drone each), rot (9), thrust_cmds_damp,
// thrust_rot_damp (4 each), field after field, each starting on a multiple
// of 4 floats.  Bool arena: on_floor, crashed_floor, crashed_wall,
// crashed_ceiling, n each.  Int arena: step_count.
__device__ __forceinline__ size_t pad4(size_t x) {
  return (x + 3) & ~size_t(3);
}

// Threads (drones) per block, a multiple of 32.
constexpr int kThreads = 64;

// Shared-memory staging of the outputs, in floats per thread of the block:
// the seven 3-vectors and rot.
constexpr int kStageOut = 30;

// max, min and clamp that keep a NaN, as the plain version's torch.clamp,
// torch.maximum and torch.minimum do (and jnp.clip in the TPU kernel):
// fmaxf and fminf return the other operand and would hide it.
__device__ __forceinline__ float maxf(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float minf(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}

// Block-wide copy of `count` contiguous floats between 16-byte aligned
// slabs, shared memory to device memory: float4 stores, with a scalar tail.
__device__ __forceinline__ void stage_out(const float* src,
                                          float* __restrict__ dst, int count) {
  const int nvec = count >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int t = threadIdx.x; t < nvec; t += kThreads) d4[t] = s4[t];
  for (int t = (nvec << 2) + threadIdx.x; t < count; t += kThreads)
    dst[t] = src[t];
}

// One drone's (.., 4) row as one 16-byte word.
__device__ __forceinline__ void load4(const float* __restrict__ base, int i,
                                      float out[4]) {
  const float4 v = reinterpret_cast<const float4*>(base)[i];
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store4(float* __restrict__ base, int i,
                                       const float v[4]) {
  reinterpret_cast<float4*>(base)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kPerDrone>
__global__ void __launch_bounds__(kThreads)
dynamics_kernel(const Params prm, const float* __restrict__ table, int rows,
                int sim_steps, int ortho_every, int n, const Io io) {
  __shared__ float4 stage4[kStageOut * kThreads / 4];
  float* const out_stage = reinterpret_cast<float*>(stage4);
  const int first = blockIdx.x * kThreads;     // this block's first drone
  const int count = min(kThreads, n - first);  // its drones (ragged last block)
  const int tid = threadIdx.x;
  const int i = first + tid;

  // Arena offsets of the float fields, from n alone.
  const size_t span3 = pad4(3 * static_cast<size_t>(n));
  const size_t span9 = pad4(9 * static_cast<size_t>(n));
  const size_t span4 = pad4(4 * static_cast<size_t>(n));
  float* const vec3_o = io.out_f;             // seven 3-vector fields
  float* const rot_o = vec3_o + 7 * span3;
  float* const cmds_damp_o = rot_o + span9;
  float* const rot_damp_o = cmds_damp_o + span4;

  if (tid < count) {
    const float* p = kPerDrone ? table + static_cast<size_t>(i % rows) * N_PARAMS
                               : prm.v;
    const float dt = p[P_DT];

    // Every load is sent before the first use, so one memory latency is
    // paid; the inputs are read once and stay in registers.
    float pos[3], vel[3], R[9], w[3], cd[4], rd[4], cmds[4], noise[4];
    load4(io.cmds_damp, i, cd);
    load4(io.rot_damp, i, rd);
    load4(io.thrust_cmds, i, cmds);
    load4(io.ou, i, noise);
    for (int a = 0; a < 3; ++a) {
      pos[a] = io.pos[3 * i + a];
      vel[a] = io.vel[3 * i + a];
      w[a] = io.omega[3 * i + a];
    }
    for (int k = 0; k < 9; ++k) R[k] = io.rot[9 * i + k];
    bool on_floor = io.on_floor[i];
    int step_count = io.step_count[i];
    const float yaw = io.yaw[i];
    for (int m = 0; m < 4; ++m) cmds[m] = clampf(cmds[m], 0.f, 1.f);
    float yaw_s, yaw_c;
    sincosf(yaw, &yaw_s, &yaw_c);

    float acc[3] = {0.f, 0.f, 0.f}, accel[3] = {0.f, 0.f, 0.f};
    float omega_dot[3] = {0.f, 0.f, 0.f}, torque[3] = {0.f, 0.f, 0.f};
    bool crashed_floor = false, crashed_wall = false, crashed_ceiling = false;

    for (int s = 0; s < sim_steps; ++s) {
      // Motor first-order filter in the sqrt domain, plus OU noise.
      float thrusts[4], thrust_total = 0.f;
      const float lin = p[P_LINEARITY];
      for (int m = 0; m < 4; ++m) {
        float tau = cmds[m] < cd[m] ? p[P_TAU_DOWN] : p[P_TAU_UP];
        tau = minf(tau, 1.f);
        rd[m] = tau * (sqrtf(cmds[m]) - rd[m]) + rd[m];
        cd[m] = clampf(rd[m] * rd[m] + cmds[m] * noise[m], 0.f, 1.f);
        thrusts[m] = p[P_THRUST_MAX + m] *
                     ((1.f - lin) * cd[m] * cd[m] + lin * cd[m]);
        thrust_total += thrusts[m];
      }

      // Torques: prop cross-products plus the reaction torque about z.
      for (int a = 0; a < 3; ++a) torque[a] = 0.f;
      for (int m = 0; m < 4; ++m) {
        torque[0] += p[P_PROP_CROSS + 3 * m + 0] * thrusts[m];
        torque[1] += p[P_PROP_CROSS + 3 * m + 1] * thrusts[m];
        torque[2] += p[P_PROP_CROSS + 3 * m + 2] * thrusts[m] +
                     p[P_TORQUE_MAX + m] * p[P_PROP_CCW + m] * cd[m];
      }

      // Rodrigues update about the world-frame omega: R <- dR R.
      float ww[3];
      for (int r = 0; r < 3; ++r)
        ww[r] = R[3 * r] * w[0] + R[3 * r + 1] * w[1] + R[3 * r + 2] * w[2];
      const float norm = sqrtf(ww[0] * ww[0] + ww[1] * ww[1] + ww[2] * ww[2]);
      float newR[9];
      if (norm > 0.f) {
        const float kx = ww[0] / norm, ky = ww[1] / norm, kz = ww[2] / norm;
        float sa, ca;
        sincosf(norm * dt, &sa, &ca);
        const float K[9] = {0.f, -kz, ky, kz, 0.f, -kx, -ky, kx, 0.f};
        float dR[9];
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) {
            const float kk = K[3 * r] * K[c] + K[3 * r + 1] * K[3 + c] +
                             K[3 * r + 2] * K[6 + c];
            dR[3 * r + c] = (r == c ? 1.f : 0.f) + sa * K[3 * r + c] +
                            (1.f - ca) * kk;
          }
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c)
            newR[3 * r + c] = dR[3 * r] * R[c] + dR[3 * r + 1] * R[3 + c] +
                              dR[3 * r + 2] * R[6 + c];
      } else {
        for (int k = 0; k < 9; ++k) newR[k] = R[k];
      }

      // Periodic Newton-polar re-orthonormalization: R <- 1.5 R - 0.5 R R^T R.
      step_count += 1;
      if (step_count >= ortho_every) {
        for (int it = 0; it < 2; ++it) {
          float G[9], T[9];
          for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c)
              G[3 * r + c] = newR[3 * r] * newR[3 * c] +
                             newR[3 * r + 1] * newR[3 * c + 1] +
                             newR[3 * r + 2] * newR[3 * c + 2];
          for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c)
              T[3 * r + c] = G[3 * r] * newR[c] + G[3 * r + 1] * newR[3 + c] +
                             G[3 * r + 2] * newR[6 + c];
          for (int k = 0; k < 9; ++k) newR[k] = 1.5f * newR[k] - 0.5f * T[k];
        }
        step_count = 0;
      }
      for (int k = 0; k < 9; ++k) R[k] = newR[k];

      // Omega: Euler with quadratic damping, then clip.
      const float* I = p + P_INERTIA;
      const float iw[3] = {I[0] * w[0], I[1] * w[1], I[2] * w[2]};
      const float cr[3] = {-w[1] * iw[2] + w[2] * iw[1],
                           -w[2] * iw[0] + w[0] * iw[2],
                           -w[0] * iw[1] + w[1] * iw[0]};
      float new_w[3];
      for (int a = 0; a < 3; ++a) {
        omega_dot[a] = (1.f / I[a]) * (cr[a] + torque[a]);
        const float damp = clampf(p[P_DAMP_OMEGA_Q] * w[a] * w[a], 0.f, 1.f);
        new_w[a] = clampf(w[a] + (1.f - damp) * dt * omega_dot[a],
                          -p[P_OMEGA_MAX], p[P_OMEGA_MAX]);
      }

      // Position + room clip.
      float pos_raw[3];
      for (int a = 0; a < 3; ++a) {
        pos_raw[a] = pos[a] + dt * vel[a];
        pos[a] = clampf(pos_raw[a], p[P_ROOM_LO + a], p[P_ROOM_HI + a]);
      }
      crashed_wall = (pos_raw[0] != pos[0]) || (pos_raw[1] != pos[1]);
      crashed_ceiling = pos_raw[2] > pos[2];

      // Floor interaction.
      const bool below = pos[2] <= p[P_FLOOR_THR];
      const bool case_a = below && on_floor;
      const bool case_b = below && !on_floor;
      if (below) pos[2] = p[P_FLOOR_THR];
      float force[3] = {R[2] * thrust_total, R[5] * thrust_total,
                        R[8] * thrust_total};
      if (below) {
        float ts, tc;
        sincosf(atan2f(R[3], R[0] + kEps), &ts, &tc);
        if (case_b && R[8] < 0.f) {  // inverted crash: random yaw
          ts = yaw_s;
          tc = yaw_c;
        }
        if (case_a) {
          const float friction = p[P_MU] * (p[P_MASS] * kGrav - force[2]);
          const float vel_norm =
              sqrtf(vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]);
          if (vel_norm < kEps) {
            const float fxy = sqrtf(force[0] * force[0] + force[1] * force[1]);
            const float static_mag = maxf(fxy - friction, 0.f);
            float fs, fc;
            sincosf(atan2f(force[1], force[0]), &fs, &fc);
            force[0] = static_mag == 0.f ? 0.f : static_mag * fc;
            force[1] = static_mag == 0.f ? 0.f : static_mag * fs;
          } else {
            float rs, rc;
            sincosf(atan2f(-vel[1], -vel[0]), &rs, &rc);
            force[0] += rc * friction;
            force[1] += rs * friction;
          }
        }
        const float flat[9] = {tc, -ts, 0.f, ts, tc, 0.f, 0.f, 0.f, 1.f};
        for (int k = 0; k < 9; ++k) R[k] = flat[k];
        if (case_b) {
          for (int a = 0; a < 3; ++a) {
            vel[a] = 0.f;
            new_w[a] = 0.f;
          }
          for (int m = 0; m < 4; ++m) {
            cd[m] = 0.f;
            rd[m] = 0.f;
          }
        }
      }
      for (int a = 0; a < 3; ++a) {
        acc[a] = force[a] / p[P_MASS];
        w[a] = new_w[a];
      }
      acc[2] = -kGrav + acc[2];
      if (below) acc[2] = maxf(acc[2], 0.f);
      on_floor = below;
      crashed_floor = case_b;

      // Velocity + accelerometer R^T (acc + g).
      for (int a = 0; a < 3; ++a)
        vel[a] = (1.f - p[P_VEL_DAMP]) * vel[a] + dt * acc[a];
      const float ag[3] = {acc[0], acc[1], acc[2] + p[P_GRAV]};
      for (int c = 0; c < 3; ++c)
        accel[c] = R[c] * ag[0] + R[3 + c] * ag[1] + R[6 + c] * ag[2];
    }

    // Results: the 3-vectors and rot into the block's output slabs, the
    // (B, 4) fields and the per-drone scalars straight to device memory.
    for (int a = 0; a < 3; ++a) {
      out_stage[0 * 3 * kThreads + 3 * tid + a] = pos[a];
      out_stage[1 * 3 * kThreads + 3 * tid + a] = vel[a];
      out_stage[2 * 3 * kThreads + 3 * tid + a] = w[a];
      out_stage[3 * 3 * kThreads + 3 * tid + a] = acc[a];
      out_stage[4 * 3 * kThreads + 3 * tid + a] = accel[a];
      out_stage[5 * 3 * kThreads + 3 * tid + a] = omega_dot[a];
      out_stage[6 * 3 * kThreads + 3 * tid + a] = torque[a];
    }
    for (int k = 0; k < 9; ++k) out_stage[21 * kThreads + 9 * tid + k] = R[k];
    store4(cmds_damp_o, i, cd);
    store4(rot_damp_o, i, rd);
    io.out_b[i] = on_floor;
    io.out_b[static_cast<size_t>(n) + i] = crashed_floor;
    io.out_b[2 * static_cast<size_t>(n) + i] = crashed_wall;
    io.out_b[3 * static_cast<size_t>(n) + i] = crashed_ceiling;
    io.out_i[i] = step_count;
  }  // tid < count

  // The block's slabs of the staged fields go out as 16-byte words: a full
  // block takes the unrolled path (ten predicated load-store pairs a
  // thread, no loop), the ragged last block the loops.  A slab starts on a
  // 16-byte boundary: its field does, and `first` is a multiple of 4.
  __syncthreads();
  float* const slab3 = vec3_o + 3 * static_cast<size_t>(first);
  float* const slab9 = rot_o + 9 * static_cast<size_t>(first);
  constexpr int kWords3 = 3 * kThreads / 4;   // float4 words of a 3-vector slab
  constexpr int kWords9 = 9 * kThreads / 4;
  if (count == kThreads) {
    if (tid < kWords3) {
#pragma unroll
      for (int f = 0; f < 7; ++f)
        reinterpret_cast<float4*>(slab3 + f * span3)[tid] =
            stage4[f * kWords3 + tid];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int q = tid + r * kThreads;
      if (q < kWords9)
        reinterpret_cast<float4*>(slab9)[q] = stage4[7 * kWords3 + q];
    }
  } else {
    for (int f = 0; f < 7; ++f)
      stage_out(out_stage + f * 3 * kThreads, slab3 + f * span3, 3 * count);
    stage_out(out_stage + 21 * kThreads, slab9, 9 * count);
  }
}

// Does nothing: its time in a CUDA graph is the card's launch floor at a
// given grid, the least any kernel of that grid can take.
__global__ void noop_kernel() {}

// Makes `device` the calling thread's current device of this library's
// CUDA runtime, which is device 0 until set: a launch must go to the
// device of the caller's stream and tensors.  0 or the error.
int use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) return 0;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of device `device` and returns
// cudaGetLastError() (0 on success).  Shared parameters: `host_params` points to N_PARAMS floats in
// host memory, copied into the launch arguments, and `table` is null.
// Per-drone parameters: `table` points to a (rows, N_PARAMS) float32 table
// in device memory, drone b reads row b % rows, and `host_params` is not
// read.  `ptrs` holds the 14 device pointers in the order of struct Io:
// the 11 inputs, then the float, bool and int32 output arenas.
// thrust_cmds_damp, thrust_rot_damp, thrust_cmds, ou and the float arena
// must be 16-byte aligned.
int qs_dynamics_step(const float* host_params, const float* table, int rows,
                     int sim_steps, int ortho_every, int n,
                     void* const* ptrs, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  Params prm = {};
  if (table == nullptr) {
    for (int k = 0; k < N_PARAMS; ++k) prm.v[k] = host_params[k];
  } else if (rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Io io;
  io.pos = static_cast<const float*>(ptrs[0]);
  io.vel = static_cast<const float*>(ptrs[1]);
  io.rot = static_cast<const float*>(ptrs[2]);
  io.omega = static_cast<const float*>(ptrs[3]);
  io.cmds_damp = static_cast<const float*>(ptrs[4]);
  io.rot_damp = static_cast<const float*>(ptrs[5]);
  io.on_floor = static_cast<const bool*>(ptrs[6]);
  io.step_count = static_cast<const int32_t*>(ptrs[7]);
  io.thrust_cmds = static_cast<const float*>(ptrs[8]);
  io.ou = static_cast<const float*>(ptrs[9]);
  io.yaw = static_cast<const float*>(ptrs[10]);
  io.out_f = static_cast<float*>(ptrs[11]);
  io.out_b = static_cast<bool*>(ptrs[12]);
  io.out_i = static_cast<int32_t*>(ptrs[13]);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table == nullptr)
      dynamics_kernel<false><<<blocks, kThreads, 0, s>>>(
          prm, nullptr, 1, sim_steps, ortho_every, n, io);
    else
      dynamics_kernel<true><<<blocks, kThreads, 0, s>>>(
          prm, table, rows, sim_steps, ortho_every, n, io);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel at the given grid, for timing the launch floor.
int qs_launch_floor(int blocks, int threads, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  noop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Threads per block of the dynamics kernel (for the launch floor's grid).
int qs_dynamics_block_threads() { return kThreads; }

const char* qs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
