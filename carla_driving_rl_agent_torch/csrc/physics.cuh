// Per-world arithmetic of the fused physics step, shared by the CUDA kernel
// (physics.cu, nvcc) and a host build (physics_host.cpp, g++) that the CPU
// tests run against the plain PyTorch version and the JAX package.
//
// One call of `step_one` is one tick of one world without NPC traffic:
// actions -> control (envs/dynamics.actions_to_control), the kinematic
// bicycle, the route-window monotone descent over 10 waypoints, similarity,
// distances, the off-road minimum over the world's cell segments, the
// collision, the default reward (damping, over-cap penalty), termination,
// truncation, and the auto-reset merge with pre-drawn reset values.  It is
// the float32 arithmetic of envs/world.step_world + the merge of
// envs/carla_env.step_physics, in their operation order, and the body of the
// Pallas kernel `_step_kernel` of carla_driving_rl_agent_tpu/ops/
// physics_pallas.py together with the gathers and the bicycle prologue that
// the TPU version left to XLA.
//
// Every division is a true IEEE division (the plain PyTorch version divides
// by tensors, not Python numbers, for the same reason), and the CUDA build
// runs with --fmad=false: no multiply-add is contracted, as PyTorch's one
// operation per kernel never contracts one.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define CDRL_HD __host__ __device__ __forceinline__
#else
#define CDRL_HD inline
#endif

namespace cdrl {

constexpr int UPDATE_WINDOW = 10;   // envs/world.UPDATE_WINDOW

// Output rows (each B long) of the three output buffers; ops/physics.py
// repeats the order.
enum FloatOut {
  F_X, F_Y, F_YAW, F_V, F_THROTTLE, F_BRAKE, F_STEER, F_SIMILARITY,
  F_SIM_TIME, F_TOTAL_REWARD, F_COLLISION_PENALTY,
  F_REWARD, F_SPEED, F_SIM_PRE, F_D_NEXT, F_D_DEST, F_OFF_ROAD,
  F_TOTAL_REWARD_PRE, N_FLOAT_OUT
};
enum IntOut { I_ROUTE, I_WP, I_TOWN, I_WEATHER, I_TIMESTEP, I_EPISODE, N_INT_OUT };
enum BoolOut { B_SHOULD_TERMINATE, B_TERM, B_TRUNC, B_DONE, B_HIT, N_BOOL_OUT };

// Everything one launch reads and writes.  Pointers are to contiguous
// device (or host) arrays; ops/physics.py fills the same layout with
// ctypes (pointers first, then floats, then ints).
struct PhysicsArgs {
  // world state, (B,) each
  const float* x;
  const float* y;
  const float* yaw;
  const float* v;
  const int64_t* route_id;
  const int64_t* wp_idx;
  const int64_t* town_id;
  const int64_t* weather_id;
  const int64_t* timestep;
  const int64_t* episode;
  const float* sim_time;
  const float* total_reward;
  // actions (B, n_actions) in [-1, 1]
  const float* action;
  // reset draws, (B,) each
  const int64_t* d_town;
  const int64_t* d_weather;
  const int64_t* d_route;
  const float* d_sim_time;
  // banks
  const int64_t* route_len;   // (T, R)
  const float* route_xyy;     // (T, R, L, 4)
  const float* route_start;   // (T, R, 4)
  const float* route_end;     // (T, R, 2)
  const float* cell_segs;     // (T, GH, GW, K * 4)
  const float* road_half;     // (T,)
  // outputs: (N_FLOAT_OUT, B) f32, (N_INT_OUT, B) i64, (N_BOOL_OUT, B) u8
  float* out_f;
  int64_t* out_i;
  uint8_t* out_b;
  // constants, each the float32 value of the Python number it replaces
  float range_throttle_lo, range_throttle_hi;
  float range_brake_lo, range_brake_hi;
  float range_steer_lo, range_steer_hi;
  float off_road_threshold;   // params.off_road_threshold
  float lane_pad;             // LANE_WIDTH + 0.3
  float penalty;              // collision_penalty / off_road_penalty_divisor
  float speed_cap;            // reward_speed_cap
  float over_cap;             // speed_over_cap_penalty
  float dt;
  float cell_res;
  int n_worlds;
  int max_timesteps;
  int n_actions;
  int throttle_as_desired_speed;
  int reverse;                // an action's third channel selects reverse
  int n_routes, route_max_len;
  int grid_h, grid_w, k_segs;
};

// envs/dynamics.py
constexpr float MS_TO_KMH = 3.6f;
constexpr float MAX_ACCEL = 3.8f;
constexpr float MAX_BRAKE = 8.0f;
constexpr float ROLL_DRAG = 0.08f;
constexpr float QUAD_DRAG = 0.0015f;
constexpr float MAX_STEER_ANGLE = 0.6109f;
constexpr float LR = 1.45f;
constexpr float LR_OVER_WHEELBASE = 0.5f;    // 1.45 / 2.9

CDRL_HD float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

CDRL_HD float dist2d(float px, float py, float x, float y) {
  // route.distance: d = point - pos, sqrt(dx * dx + dy * dy)
  const float dx = px - x;
  const float dy = py - y;
  return sqrtf(dx * dx + dy * dy);
}

CDRL_HD void step_one(const PhysicsArgs& a, int i) {
  const int64_t t = a.town_id[i];
  const int64_t r = a.route_id[i];

  // ---- actions_to_control ----
  const float a0 = a.action[static_cast<int64_t>(i) * a.n_actions];
  const float a1 = a.action[static_cast<int64_t>(i) * a.n_actions + 1];
  float throttle = a0 > 0.0f ? a0 : 0.0f;
  float brake = a0 < 0.0f ? -a0 : 0.0f;
  float rev = 0.0f;
  if (a.reverse) rev = a.action[static_cast<int64_t>(i) * a.n_actions + 2] > 0.0f ? 1.0f : 0.0f;
  const float v0 = a.v[i];
  if (a.throttle_as_desired_speed) {
    const float desired = (a0 + 1.0f) / 2.0f * 100.0f;
    const float current = v0 * MS_TO_KMH;
    throttle = current < desired ? (desired - current) / 100.0f : 0.0f;
    brake = current > desired ? (current - desired) / 100.0f : 0.0f;
  }
  throttle = clampf(throttle, a.range_throttle_lo, a.range_throttle_hi);
  brake = clampf(brake, a.range_brake_lo, a.range_brake_hi);
  const float steer = clampf(a1, a.range_steer_lo, a.range_steer_hi);

  // ---- step_bicycle ----
  const float accel = throttle * MAX_ACCEL - brake * MAX_BRAKE;
  const float drag = ROLL_DRAG * v0 + QUAD_DRAG * v0 * v0;
  const float v = fmaxf(v0 + (accel - drag) * a.dt, 0.0f);
  const float delta = steer * MAX_STEER_ANGLE;
  const float beta = atanf(tanf(delta) * LR_OVER_WHEELBASE);
  const float v_mid = 0.5f * (v0 + v);
  const float direction = 1.0f - 2.0f * rev;
  const float x = a.x[i] + direction * v_mid * cosf(a.yaw[i] + beta) * a.dt;
  const float y = a.y[i] + direction * v_mid * sinf(a.yaw[i] + beta) * a.dt;
  float yaw = a.yaw[i] + direction * (v_mid / LR) * sinf(beta) * a.dt;
  yaw = atan2f(sinf(yaw), cosf(yaw));

  // ---- route window and monotone descent (route.update_index) ----
  const int64_t route_row = t * a.n_routes + r;
  const int64_t rem = a.route_len[route_row] - a.wp_idx[i];
  const float* xyy = a.route_xyy + route_row * a.route_max_len * 4;
  float d[UPDATE_WINDOW];
  int64_t rows[UPDATE_WINDOW];
  for (int k = 0; k < UPDATE_WINDOW; ++k) {
    int64_t row = a.wp_idx[i] + (k < rem - 1 ? k : rem - 1);
    row = row < 0 ? 0 : (row >= a.route_max_len ? a.route_max_len - 1 : row);
    rows[k] = row;
    d[k] = dist2d(xyy[row * 4], xyy[row * 4 + 1], x, y);
  }
  int64_t steps = 0;
  bool keep = true;
  for (int k = 0; k < UPDATE_WINDOW - 1; ++k) {
    keep = keep && (d[k + 1] < d[k]);
    steps += keep ? 1 : 0;
  }
  const int64_t local = steps < rem - 1 ? steps : rem - 1;
  const int lk = local < 0 ? 0 : static_cast<int>(local);
  const float* nxt = xyy + rows[lk] * 4;
  const float similarity = cosf(yaw - nxt[2]);
  const float d_next = dist2d(nxt[0], nxt[1], x, y);
  const float* end_xy = a.route_end + route_row * 2;
  const float d_dest = dist2d(end_xy[0], end_xy[1], x, y);

  // ---- off-road distance over the cell's packed segments ----
  int64_t cx = static_cast<int64_t>(x / a.cell_res);
  int64_t cy = static_cast<int64_t>(y / a.cell_res);
  cx = cx < 0 ? 0 : (cx > a.grid_w - 1 ? a.grid_w - 1 : cx);
  cy = cy < 0 ? 0 : (cy > a.grid_h - 1 ? a.grid_h - 1 : cy);
  const float* segs = a.cell_segs + ((t * a.grid_h + cy) * a.grid_w + cx) * a.k_segs * 4;
  float best = INFINITY;
  for (int k = 0; k < a.k_segs; ++k) {
    const float x0 = segs[4 * k], y0 = segs[4 * k + 1];
    const float ex = segs[4 * k + 2] - x0;
    const float ey = segs[4 * k + 3] - y0;
    const float L2 = fmaxf(ex * ex + ey * ey, 1e-9f);
    const float rx = x - x0;
    const float ry = y - y0;
    const float tt = clampf((rx * ex + ry * ey) / L2, 0.0f, 1.0f);
    const float dx = rx - tt * ex;
    const float dy = ry - tt * ey;
    best = fminf(best, dx * dx + dy * dy);
  }
  const float off_road = sqrtf(best);

  // ---- collision: zero NPCs, so only the off-road check ----
  const float off_thr = a.off_road_threshold + (a.road_half[t] - a.lane_pad);
  const bool hit = off_road > off_thr;
  const float cp = hit ? a.penalty : 0.0f;

  // ---- default reward ----
  const float spd = fabsf(v) * MS_TO_KMH;
  float r_drive = fminf(spd, a.speed_cap) * similarity;
  const float half = d_next / 2.0f;
  const float damp = fmaxf(half * half, 1.0f);
  if (r_drive != 0.0f) r_drive = r_drive / damp;
  float reward = cp > 0.0f ? -cp : r_drive;
  if (a.over_cap != 0.0f) reward = reward - a.over_cap * fmaxf(spd - a.speed_cap, 0.0f);

  // ---- termination, truncation, bookkeeping ----
  const bool arrived = d_dest <= 2.0f;
  const bool term = hit || arrived;
  const int64_t timestep = a.timestep[i] + 1;
  const bool trunc = timestep >= a.max_timesteps && !term;
  const bool done = term || trunc;
  const float total_reward = a.total_reward[i] + reward;
  const float sim_time = a.sim_time[i] + a.dt;

  // ---- auto-reset merge: where(done, fresh, stepped) ----
  const int n = a.n_worlds;
  float* of = a.out_f;
  int64_t* oi = a.out_i;
  uint8_t* ob = a.out_b;
  if (done) {
    const int64_t ft = a.d_town[i], fr = a.d_route[i];
    const float* start = a.route_start + (ft * a.n_routes + fr) * 4;
    of[F_X * n + i] = start[0];
    of[F_Y * n + i] = start[1];
    of[F_YAW * n + i] = start[2];
    of[F_V * n + i] = 0.0f;
    of[F_THROTTLE * n + i] = 0.0f;
    of[F_BRAKE * n + i] = 0.0f;
    of[F_STEER * n + i] = 0.0f;
    of[F_SIMILARITY * n + i] = 1.0f;
    of[F_SIM_TIME * n + i] = a.d_sim_time[i];
    of[F_TOTAL_REWARD * n + i] = 0.0f;
    of[F_COLLISION_PENALTY * n + i] = 0.0f;
    oi[I_ROUTE * n + i] = fr;
    oi[I_WP * n + i] = 1;
    oi[I_TOWN * n + i] = ft;
    oi[I_WEATHER * n + i] = a.d_weather[i];
    oi[I_TIMESTEP * n + i] = 0;
    oi[I_EPISODE * n + i] = a.episode[i] + 1;
    ob[B_SHOULD_TERMINATE * n + i] = 0;
  } else {
    of[F_X * n + i] = x;
    of[F_Y * n + i] = y;
    of[F_YAW * n + i] = yaw;
    of[F_V * n + i] = v;
    of[F_THROTTLE * n + i] = throttle;
    of[F_BRAKE * n + i] = brake;
    of[F_STEER * n + i] = steer;
    of[F_SIMILARITY * n + i] = similarity;
    of[F_SIM_TIME * n + i] = sim_time;
    of[F_TOTAL_REWARD * n + i] = total_reward;
    of[F_COLLISION_PENALTY * n + i] = cp;
    oi[I_ROUTE * n + i] = r;
    oi[I_WP * n + i] = a.wp_idx[i] + local;
    oi[I_TOWN * n + i] = t;
    oi[I_WEATHER * n + i] = a.weather_id[i];
    oi[I_TIMESTEP * n + i] = timestep;
    oi[I_EPISODE * n + i] = a.episode[i];
    ob[B_SHOULD_TERMINATE * n + i] = hit ? 1 : 0;
  }
  // the step's own returns and info, before the merge
  of[F_REWARD * n + i] = reward;
  of[F_SPEED * n + i] = spd;
  of[F_SIM_PRE * n + i] = similarity;
  of[F_D_NEXT * n + i] = d_next;
  of[F_D_DEST * n + i] = d_dest;
  of[F_OFF_ROAD * n + i] = off_road;
  of[F_TOTAL_REWARD_PRE * n + i] = total_reward;
  ob[B_TERM * n + i] = term ? 1 : 0;
  ob[B_TRUNC * n + i] = trunc ? 1 : 0;
  ob[B_DONE * n + i] = done ? 1 : 0;
  ob[B_HIT * n + i] = hit ? 1 : 0;
}

}  // namespace cdrl
