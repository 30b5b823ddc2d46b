// Per-world arithmetic of the fused physics step, shared by the CUDA kernel
// (physics.cu, nvcc) and a host build (physics_host.cpp, g++) that the CPU
// tests run against the plain PyTorch version and the JAX package.
//
// `tick` is one tick of one world without NPC traffic:
// actions -> control (envs/dynamics.actions_to_control), the kinematic
// bicycle, the route-window monotone descent over 10 waypoints, similarity,
// distances, the off-road minimum over the world's cell segments, the
// collision, the default reward (damping, over-cap penalty), termination,
// truncation, and the auto-reset merge with pre-drawn reset values.  It is
// the float32 arithmetic of envs/world.step_world + the merge of
// envs/carla_env.step_physics, in their operation order, and the body of the
// Pallas kernel `_step_kernel` of carla_driving_rl_agent_tpu/ops/
// physics_pallas.py together with the gathers and the bicycle prologue that
// the TPU version left to XLA.  `step_world_ticks` runs one world through
// K such ticks, its state in registers in between: the JAX package's
// `lax.scan` over a rollout block's ticks (agents/rollout.py), in one
// launch.
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

// Output rows.  The state after the last tick: (N_STATE_F, B) f32,
// (N_INT_OUT, B) i64, (N_STATE_B, B) u8.  Each tick's returns and info:
// (n_tick_f, K, B) f32 and (n_tick_b, K, B) u8, the first n_tick_f /
// n_tick_b rows of TickFloat / TickBool (a block call writes the rows the
// rollout records, a single tick all of them).  ops/physics.py repeats the
// order.
enum StateFloat {
  F_X, F_Y, F_YAW, F_V, F_THROTTLE, F_BRAKE, F_STEER, F_SIMILARITY,
  F_SIM_TIME, F_TOTAL_REWARD, F_COLLISION_PENALTY, N_STATE_F
};
enum IntOut { I_ROUTE, I_WP, I_TOWN, I_WEATHER, I_TIMESTEP, I_EPISODE, N_INT_OUT };
enum StateBool { B_SHOULD_TERMINATE, N_STATE_B };
enum TickFloat {
  T_REWARD, T_SPEED, T_SIMILARITY, T_D_NEXT, T_D_DEST, T_OFF_ROAD, T_TOTAL_REWARD, N_TICK_F
};
enum TickBool { T_TERM, T_TRUNC, T_DONE, T_HIT, N_TICK_B };
constexpr int BLOCK_TICK_F = 3;   // reward, speed, similarity
constexpr int BLOCK_TICK_B = 3;   // terminated, truncated, done

// Everything one launch reads and writes.  Pointers are to contiguous
// device (or host) arrays; ops/physics.py fills the same layout with
// ctypes (pointers first, then floats, then ints).
struct PhysicsArgs {
  // world state before the first tick, (B,) each
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
  // actions (K, B, n_actions) in [-1, 1]
  const float* action;
  // reset draws, (K, B) each: tick k's restart of the worlds it ends
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
  // outputs, see StateFloat .. TickBool
  float* out_f;
  int64_t* out_i;
  uint8_t* out_b;
  float* tick_f;
  uint8_t* tick_b;
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
  int n_ticks;                // K
  int n_tick_f, n_tick_b;     // the TickFloat / TickBool rows written
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

// One world's state, kept in registers across a block's ticks.
struct World {
  float x, y, yaw, v, throttle, brake, steer, similarity, sim_time, total_reward,
      collision_penalty;
  int64_t route, wp, town, weather, timestep, episode;
  bool should_terminate;
};

// One tick's returns and info, before the auto-reset merge.
struct Tick {
  float f[N_TICK_F];
  bool b[N_TICK_B];
};

CDRL_HD World load_world(const PhysicsArgs& a, int i) {
  World w;
  w.x = a.x[i]; w.y = a.y[i]; w.yaw = a.yaw[i]; w.v = a.v[i];
  w.throttle = w.brake = w.steer = w.similarity = w.collision_penalty = 0.0f;
  w.sim_time = a.sim_time[i]; w.total_reward = a.total_reward[i];
  w.route = a.route_id[i]; w.wp = a.wp_idx[i]; w.town = a.town_id[i];
  w.weather = a.weather_id[i]; w.timestep = a.timestep[i]; w.episode = a.episode[i];
  w.should_terminate = false;
  return w;
}

// Tick s of world i: the stepped state, or where the tick ends the episode
// the fresh one from tick s's reset draws, replaces *w.
CDRL_HD Tick tick(const PhysicsArgs& a, int s, int i, World* w) {
  const int64_t t = w->town;
  const int64_t r = w->route;
  const int64_t row = static_cast<int64_t>(s) * a.n_worlds + i;

  // ---- actions_to_control ----
  const float a0 = a.action[row * a.n_actions];
  const float a1 = a.action[row * a.n_actions + 1];
  float throttle = a0 > 0.0f ? a0 : 0.0f;
  float brake = a0 < 0.0f ? -a0 : 0.0f;
  float rev = 0.0f;
  if (a.reverse) rev = a.action[row * a.n_actions + 2] > 0.0f ? 1.0f : 0.0f;
  const float v0 = w->v;
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
  const float x = w->x + direction * v_mid * cosf(w->yaw + beta) * a.dt;
  const float y = w->y + direction * v_mid * sinf(w->yaw + beta) * a.dt;
  float yaw = w->yaw + direction * (v_mid / LR) * sinf(beta) * a.dt;
  yaw = atan2f(sinf(yaw), cosf(yaw));

  // ---- route window and monotone descent (route.update_index) ----
  const int64_t route_row = t * a.n_routes + r;
  const int64_t rem = a.route_len[route_row] - w->wp;
  const float* xyy = a.route_xyy + route_row * a.route_max_len * 4;
  float d[UPDATE_WINDOW];
  int64_t rows[UPDATE_WINDOW];
  for (int k = 0; k < UPDATE_WINDOW; ++k) {
    int64_t wrow = w->wp + (k < rem - 1 ? k : rem - 1);
    wrow = wrow < 0 ? 0 : (wrow >= a.route_max_len ? a.route_max_len - 1 : wrow);
    rows[k] = wrow;
    d[k] = dist2d(xyy[wrow * 4], xyy[wrow * 4 + 1], x, y);
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
  const int64_t timestep = w->timestep + 1;
  const bool trunc = timestep >= a.max_timesteps && !term;
  const bool done = term || trunc;
  const float total_reward = w->total_reward + reward;
  const float sim_time = w->sim_time + a.dt;

  // ---- auto-reset merge: where(done, fresh, stepped) ----
  if (done) {
    const int64_t ft = a.d_town[row], fr = a.d_route[row];
    const float* start = a.route_start + (ft * a.n_routes + fr) * 4;
    w->x = start[0];
    w->y = start[1];
    w->yaw = start[2];
    w->v = w->throttle = w->brake = w->steer = 0.0f;
    w->similarity = 1.0f;
    w->sim_time = a.d_sim_time[row];
    w->total_reward = w->collision_penalty = 0.0f;
    w->route = fr;
    w->wp = 1;
    w->town = ft;
    w->weather = a.d_weather[row];
    w->timestep = 0;
    w->episode += 1;
    w->should_terminate = false;
  } else {
    w->x = x;
    w->y = y;
    w->yaw = yaw;
    w->v = v;
    w->throttle = throttle;
    w->brake = brake;
    w->steer = steer;
    w->similarity = similarity;
    w->sim_time = sim_time;
    w->total_reward = total_reward;
    w->collision_penalty = cp;
    w->wp += local;
    w->timestep = timestep;
    w->should_terminate = hit;
  }
  // the tick's own returns and info, before the merge
  Tick out;
  out.f[T_REWARD] = reward;
  out.f[T_SPEED] = spd;
  out.f[T_SIMILARITY] = similarity;
  out.f[T_D_NEXT] = d_next;
  out.f[T_D_DEST] = d_dest;
  out.f[T_OFF_ROAD] = off_road;
  out.f[T_TOTAL_REWARD] = total_reward;
  out.b[T_TERM] = term;
  out.b[T_TRUNC] = trunc;
  out.b[T_DONE] = done;
  out.b[T_HIT] = hit;
  return out;
}

// World i through the launch's K ticks: its state read once, kept in
// registers, written once after the last tick; each tick's rows written as
// they come.
CDRL_HD void step_world_ticks(const PhysicsArgs& a, int i) {
  const int n = a.n_worlds;
  const int64_t kn = static_cast<int64_t>(a.n_ticks) * n;
  World w = load_world(a, i);
  for (int s = 0; s < a.n_ticks; ++s) {
    const Tick r = tick(a, s, i, &w);
    const int64_t at = static_cast<int64_t>(s) * n + i;
    for (int j = 0; j < a.n_tick_f; ++j) a.tick_f[j * kn + at] = r.f[j];
    for (int j = 0; j < a.n_tick_b; ++j) a.tick_b[j * kn + at] = r.b[j] ? 1 : 0;
  }
  float* of = a.out_f;
  int64_t* oi = a.out_i;
  of[F_X * n + i] = w.x;
  of[F_Y * n + i] = w.y;
  of[F_YAW * n + i] = w.yaw;
  of[F_V * n + i] = w.v;
  of[F_THROTTLE * n + i] = w.throttle;
  of[F_BRAKE * n + i] = w.brake;
  of[F_STEER * n + i] = w.steer;
  of[F_SIMILARITY * n + i] = w.similarity;
  of[F_SIM_TIME * n + i] = w.sim_time;
  of[F_TOTAL_REWARD * n + i] = w.total_reward;
  of[F_COLLISION_PENALTY * n + i] = w.collision_penalty;
  oi[I_ROUTE * n + i] = w.route;
  oi[I_WP * n + i] = w.wp;
  oi[I_TOWN * n + i] = w.town;
  oi[I_WEATHER * n + i] = w.weather;
  oi[I_TIMESTEP * n + i] = w.timestep;
  oi[I_EPISODE * n + i] = w.episode;
  a.out_b[B_SHOULD_TERMINATE * n + i] = w.should_terminate ? 1 : 0;
}

}  // namespace cdrl
