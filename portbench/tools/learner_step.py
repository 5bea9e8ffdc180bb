"""train.sh's learner without the profiler: `sgd_epochs` over a rollout of
8 ticks at train.sh's 1024 x 8 (64 minibatch steps of 1024, as
`chip_smoke.py --phases build,profile --profile_path train` takes it), the
wall ms a minibatch step for 9 calls, the first 2 dropped.  From the root
of a tree, on the card (or, with `cpu`, at a small size on the CPU):

    python3 portbench/tools/learner_step.py [cpu]
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quadswarm_tpu_torch.parallel import ppo as P  # noqa: E402

cpu = sys.argv[1:] == ["cpu"]
dev = "cpu" if cpu else "cuda"
sync = (lambda: None) if cpu else torch.cuda.synchronize
argv = None if not cpu else cs.train_sh_flags() + [
    "--num_envs=4", "--batch_size=32", "--rnn_size=16",
    "--quads_neighbor_hidden_size=16"]
tr = cs._flagship_trainer(device=dev, argv=argv)
tr.set_ppo_cfg(tr.ppo_cfg.replace(rollout=8))
tr.iteration()
_, _, _, traj, last_value, _ = P.collect_rollout(
    tr.env_cfg, tr.dyn_params, tr.model, tr.ppo_cfg, tr.env_states, tr.obs,
    tr.gen, tr.current_rew_coeff(), tr.replay_states, tr.norm_state)
adv, ret = P.compute_gae(traj, last_value, tr.ppo_cfg.gamma,
                         tr.ppo_cfg.gae_lambda)
steps = P.minibatch_layout(tuple(traj.reward.shape),
                           tr.ppo_cfg.batch_size).num_minibatches
walls = []
for _ in range(9):
    sync()
    t0 = time.perf_counter()
    P.sgd_epochs(tr.model, tr.optimizer, tr.ppo_cfg, traj, adv, ret, tr.gen)
    sync()
    walls.append((time.perf_counter() - t0) / steps * 1e3)
print(json.dumps({"tree": os.getcwd(), "steps": steps,
                  "ms_per_step": walls[2:],
                  "median": statistics.median(walls[2:])}))
