"""Envs and offline data shared by the rllib tests of both packages and by
``chip_smoke.py``'s copy: the cooperative matching game of
``test_rllib_multi_agent.py`` and transitions of its scripted expert.
Imports neither torch nor JAX; callers ship ``make_matching_env`` to the
runners by value (``cloudpickle.register_pickle_by_value``)."""

import numpy as np


def make_matching_env():
    """Factory (cloudpickled BY VALUE — test modules aren't importable in
    workers): two agents see the same random context bit and earn +1 each
    when BOTH play the action equal to the bit. Optimal return per 20-step
    episode = 40 total; random play averages ~10."""
    import numpy as _np

    class MatchingEnv:
        agents = ("a0", "a1")

        def __init__(self, episode_len=20):
            self.episode_len = episode_len
            self._rng = _np.random.default_rng(0)
            self._t = 0
            self._bit = 0

        def _obs(self):
            v = _np.asarray([self._bit, 1 - self._bit], _np.float32)
            return {a: v for a in self.agents}

        def reset(self, seed=None):
            if seed is not None:
                self._rng = _np.random.default_rng(seed)
            self._t = 0
            self._bit = int(self._rng.integers(2))
            return self._obs(), {}

        def step(self, actions):
            hit = all(actions[a] == self._bit for a in self.agents)
            rew = {a: (1.0 if hit else 0.0) for a in self.agents}
            self._t += 1
            self._bit = int(self._rng.integers(2))
            done = self._t >= self.episode_len
            terms = {a: done for a in self.agents}
            truncs = {a: False for a in self.agents}
            return self._obs(), rew, terms, truncs, {}

    return MatchingEnv()


def matching_expert_rows(n, seed=0, eps=0.0):
    """``n`` transitions of agent a0 in the matching game under its
    scripted expert (play the bit), each action replaced by a uniform one
    with probability ``eps``: rows of obs, action, reward, next_obs and
    terminated, as BC and CQL read them. The reward is a0's own: 1 when
    its action matches the bit (the partner plays the expert)."""
    rng = np.random.default_rng(seed)
    env = make_matching_env()
    obs, _ = env.reset(seed=seed)
    rows = []
    for _ in range(n):
        bit = int(obs["a0"][0])
        a = bit if rng.random() >= eps else int(rng.integers(2))
        nxt, rew, terms, _, _ = env.step({"a0": a, "a1": bit})
        rows.append({"obs": np.asarray(obs["a0"], np.float32), "action": a,
                     "reward": float(rew["a0"]),
                     "next_obs": np.asarray(nxt["a0"], np.float32),
                     "terminated": float(terms["a0"])})
        obs = nxt
        if terms["a0"]:
            obs, _ = env.reset()
    return rows


def held_out_observations(n, seed):
    """``n`` observations of the game from a seed of their own, and the
    expert's action for each."""
    bits = np.random.default_rng(seed).integers(0, 2, n)
    obs = np.stack([bits, 1 - bits], axis=1).astype(np.float32)
    return obs, bits.astype(np.int64)
