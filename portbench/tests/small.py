"""Small sizes of each cell for the CPU tests: the configuration's flags
with fewer envs, drones, ticks and units, every mechanism kept."""

SMALL = {
    "rollout.swarm128": ["--num_envs=2", "--quads_num_agents=8",
                         "--rollout=8", "--rnn_size=16",
                         "--quads_neighbor_hidden_size=16"],
}
SEED = 2 ** 31 + 12345
