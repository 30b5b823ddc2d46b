"""How far a bfloat16 training step's gradients lie from float32 ones at
the tests' tiny widths, on the CPU: the policy-phase gradients of one
minibatch (tests/test_torch_learner.py's TINY_NET, 45 x 180 frames, batch
MB) from the same float32 parameters, for JAX's compute_dtype=bfloat16
network against JAX's float32 one (the noise floor), and for the port's
bfloat16 network against JAX's bfloat16 one.  Prints the median and the
largest relative L2 per tensor of each, by part of the network.

    python tests/bf16_noise_floor.py [MB]

Not collected by pytest (no test_ prefix): tests/test_torch_bf16.py leaves
the backbone's bf16 gradients out of its bars on what this prints.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import conftest  # noqa: E402,F401  (the CPU platform)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet  # noqa: E402
from carla_driving_rl_agent_torch.agents.carla_agent import (  # noqa: E402
    CARLAgent, CARLAgentConfig)
from carla_driving_rl_agent_torch.envs import world as tworld  # noqa: E402
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig  # noqa: E402
from test_torch_imitation import jax_trees  # noqa: E402
from test_torch_learner import HYPER, T, H, W, TINY_NET, _as_torch, _jself  # noqa: E402


def main(mb: int = 8) -> None:
    env = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(town_names=("Town02",), num_routes=8,
                                                           max_timesteps=12),
                                  image_height=45, image_width=60), device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, compute_dtype="bfloat16"),
                      weights_dir="unused")
    rng = np.random.default_rng(1)
    a = rng.uniform(0.05, 0.95, (mb, 2)).astype(np.float32)
    batch = dict(obs=dict(state_image=rng.uniform(0, 1, (mb, T, H, W, 3)).astype(np.float32),
                          state_road=rng.uniform(0, 1, (mb, T, 9)).astype(np.float32),
                          state_vehicle=rng.uniform(0, 1, (mb, T, 4)).astype(np.float32),
                          state_navigation=rng.uniform(0, 3, (mb, T, 5)).astype(np.float32),
                          action=a),
                 advantages=rng.normal(0, 1, mb).astype(np.float32),
                 returns=np.stack([rng.uniform(-1, 1, mb), rng.integers(0, 4, mb)],
                                  -1).astype(np.float32),
                 log_prob=(np.log(a) - 0.3).astype(np.float32),
                 speed=rng.uniform(0, 0.5, mb).astype(np.float32),
                 similarity=rng.uniform(0.5, 1, mb).astype(np.float32))
    _, params, stats = jax_trees(agent.network, jnp.float32)
    ref = {}
    for dt in (jnp.bfloat16, jnp.float32):
        js = _jself(JNet(**TINY_NET, compute_dtype=dt))

        @jax.jit
        def grads(params, stats, b):
            def loss(pd):
                return js._policy_loss(pd["policy"], pd["dynamics"], stats, b, HYPER,
                                       jax.random.PRNGKey(0))[0]
            return jax.grad(loss)(dict(policy=params["policy"], dynamics=params["dynamics"]))

        ref[dt] = _as_torch(params, stats, grads(params, stats,
                                                 jax.tree_util.tree_map(jnp.asarray, batch)))
    tb = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in batch.items()}
    net = agent.network
    feat = net.dynamics_apply(tb["obs"], training=True)
    loss, _ = agent._policy_objective(net.policy_apply(feat, training=True), tb, HYPER)
    got = agent._grads(loss, ("policy", "dynamics"))
    names = {id(p): n for n, p in net.named_parameters()}
    rel = lambda x, y: float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))  # noqa: E731
    parts = {}
    for group in ("policy", "dynamics"):
        for p, g in zip(agent.params[group], got[group]):
            n = names[id(p)]
            part = ".".join(n.split(".")[:2]) if group == "dynamics" else group
            r16, r32 = ref[jnp.bfloat16][n].numpy(), ref[jnp.float32][n].numpy()
            parts.setdefault(part, []).append((rel(g.numpy(), r16), rel(r16, r32)))
    print(f"batch {mb}: relative L2 per tensor, median / largest")
    print(f"{'part':36s} {'port bf16 vs JAX bf16':>24s} {'JAX bf16 vs JAX f32':>24s}")
    for part, v in parts.items():
        a, b = np.array(v).T
        print(f"{part:36s} {np.median(a):11.4f} / {a.max():10.4f} {np.median(b):11.4f} / "
              f"{b.max():10.4f}")
    allv = np.array([x for v in parts.values() for x in v]).T
    print(f"{'all':36s} {np.median(allv[0]):11.4f} / {allv[0].max():10.4f} "
          f"{np.median(allv[1]):11.4f} / {allv[1].max():10.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
