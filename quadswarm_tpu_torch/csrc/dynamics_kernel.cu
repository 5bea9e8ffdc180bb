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
// that is 2.5 MB, under 1 us of HBM time at 3.35 TB/s, so the kernel is
// bound by launch latency, not by bytes or operations.  The design is the
// simplest that keeps every intermediate in registers: fields are read and
// written in their natural row-major layouts through separate pointers (no
// packing into planes, which on this card would be two extra passes over
// the same bytes), the 44 shared parameters travel by value in the launch
// arguments, and nothing is staged through shared memory.
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

struct Io {
  const float* pos; const float* vel; const float* rot; const float* omega;
  const float* cmds_damp; const float* rot_damp; const bool* on_floor;
  const int32_t* step_count; const float* thrust_cmds; const float* ou;
  const float* yaw;
  float* pos_o; float* vel_o; float* rot_o; float* omega_o;
  float* cmds_damp_o; float* rot_damp_o; float* acc_o; float* accel_o;
  float* omega_dot_o; float* torque_o; bool* on_floor_o;
  bool* crashed_floor_o; bool* crashed_wall_o; bool* crashed_ceiling_o;
  int32_t* step_count_o;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void dynamics_kernel(const Params prm, int sim_steps,
                                int ortho_every, int n, const Io io) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = prm.v;
  const float dt = p[P_DT];

  float pos[3], vel[3], R[9], w[3], cd[4], rd[4], cmds[4], noise[4];
  for (int a = 0; a < 3; ++a) {
    pos[a] = io.pos[3 * i + a];
    vel[a] = io.vel[3 * i + a];
    w[a] = io.omega[3 * i + a];
  }
  for (int k = 0; k < 9; ++k) R[k] = io.rot[9 * i + k];
  for (int m = 0; m < 4; ++m) {
    cd[m] = io.cmds_damp[4 * i + m];
    rd[m] = io.rot_damp[4 * i + m];
    cmds[m] = clampf(io.thrust_cmds[4 * i + m], 0.f, 1.f);
    noise[m] = io.ou[4 * i + m];
  }
  bool on_floor = io.on_floor[i];
  int step_count = io.step_count[i];
  float yaw_s, yaw_c;
  sincosf(io.yaw[i], &yaw_s, &yaw_c);

  float acc[3] = {0.f, 0.f, 0.f}, accel[3] = {0.f, 0.f, 0.f};
  float omega_dot[3] = {0.f, 0.f, 0.f}, torque[3] = {0.f, 0.f, 0.f};
  bool crashed_floor = false, crashed_wall = false, crashed_ceiling = false;

  for (int s = 0; s < sim_steps; ++s) {
    // Motor first-order filter in the sqrt domain, plus OU noise.
    float thrusts[4], thrust_total = 0.f;
    const float lin = p[P_LINEARITY];
    for (int m = 0; m < 4; ++m) {
      float tau = cmds[m] < cd[m] ? p[P_TAU_DOWN] : p[P_TAU_UP];
      tau = fminf(tau, 1.f);
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
      pos[a] = fminf(fmaxf(pos_raw[a], p[P_ROOM_LO + a]), p[P_ROOM_HI + a]);
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
          const float static_mag = fmaxf(fxy - friction, 0.f);
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
    if (below) acc[2] = fmaxf(acc[2], 0.f);
    on_floor = below;
    crashed_floor = case_b;

    // Velocity + accelerometer R^T (acc + g).
    for (int a = 0; a < 3; ++a)
      vel[a] = (1.f - p[P_VEL_DAMP]) * vel[a] + dt * acc[a];
    const float ag[3] = {acc[0], acc[1], acc[2] + p[P_GRAV]};
    for (int c = 0; c < 3; ++c)
      accel[c] = R[c] * ag[0] + R[3 + c] * ag[1] + R[6 + c] * ag[2];
  }

  for (int a = 0; a < 3; ++a) {
    io.pos_o[3 * i + a] = pos[a];
    io.vel_o[3 * i + a] = vel[a];
    io.omega_o[3 * i + a] = w[a];
    io.acc_o[3 * i + a] = acc[a];
    io.accel_o[3 * i + a] = accel[a];
    io.omega_dot_o[3 * i + a] = omega_dot[a];
    io.torque_o[3 * i + a] = torque[a];
  }
  for (int k = 0; k < 9; ++k) io.rot_o[9 * i + k] = R[k];
  for (int m = 0; m < 4; ++m) {
    io.cmds_damp_o[4 * i + m] = cd[m];
    io.rot_damp_o[4 * i + m] = rd[m];
  }
  io.on_floor_o[i] = on_floor;
  io.crashed_floor_o[i] = crashed_floor;
  io.crashed_wall_o[i] = crashed_wall;
  io.crashed_ceiling_o[i] = crashed_ceiling;
  io.step_count_o[i] = step_count;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  `host_params` points to N_PARAMS floats in host memory; they
// are copied into the launch arguments.  `ptrs` holds the 26 device
// pointers in the order of struct Io.
int qs_dynamics_step(const float* host_params, int sim_steps,
                     int ortho_every, int n, void* const* ptrs,
                     void* stream) {
  Params prm;
  for (int k = 0; k < N_PARAMS; ++k) prm.v[k] = host_params[k];
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
  io.pos_o = static_cast<float*>(ptrs[11]);
  io.vel_o = static_cast<float*>(ptrs[12]);
  io.rot_o = static_cast<float*>(ptrs[13]);
  io.omega_o = static_cast<float*>(ptrs[14]);
  io.cmds_damp_o = static_cast<float*>(ptrs[15]);
  io.rot_damp_o = static_cast<float*>(ptrs[16]);
  io.acc_o = static_cast<float*>(ptrs[17]);
  io.accel_o = static_cast<float*>(ptrs[18]);
  io.omega_dot_o = static_cast<float*>(ptrs[19]);
  io.torque_o = static_cast<float*>(ptrs[20]);
  io.on_floor_o = static_cast<bool*>(ptrs[21]);
  io.crashed_floor_o = static_cast<bool*>(ptrs[22]);
  io.crashed_wall_o = static_cast<bool*>(ptrs[23]);
  io.crashed_ceiling_o = static_cast<bool*>(ptrs[24]);
  io.step_count_o = static_cast<int32_t*>(ptrs[25]);
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    dynamics_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        prm, sim_steps, ortho_every, n, io);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* qs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
