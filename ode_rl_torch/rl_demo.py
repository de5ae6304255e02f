"""The Dreamer RL loop end to end on one card.

    python -m ode_rl_torch.rl_demo [--wm_steps 2000] [--behavior_steps 600]
        [--batch 16] [--episode_len 12] [--horizon 15]
        [--eval_episodes 64] [--eval_len 20]
        [--report results/torch/dreamer_rl.json] [--device cuda]

Counterpart of ``scripts/dreamer_rl_demo.py``, with its flags and
defaults:

1. collect random-policy episodes of ControlledDigit (wm/envs.py:
   velocity actions in [-1, 1]^2, the x-position as reward) on the card;
2. train an action-conditioned world model on them (depth 16, 16 x 16
   discrete latents, deter and hidden 128, a reward head) with
   ``world_model_optimizer`` (lr 3e-4), a fresh batch a step;
3. train the actor-critic in the world model's imagination
   (wm/behavior.py: 'tanh_normal', 3 layers of 200, actor lr 1e-4, value
   lr 3e-4, 'dynamics' gradients), seeded from the posteriors of fresh
   random episodes;
4. run the actor's mode and the random policy in the environment and
   report both mean rewards.

The report has the script's keys plus ``device``. ``--device`` defaults
to ``cuda``, and a host without CUDA raises rather than fall back to the
CPU. TF32 is off, as in ``ode_rl_torch.main``. Every draw comes from
generators seeded by the stage, as the script seeds each stage's key
(the draws are not JAX's).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Dict, Optional, Sequence

import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.wm import envs
from ode_rl_torch.wm.behavior import ImagBehavior, rssm_behavior_fns
from ode_rl_torch.wm.world_model import WorldModel, world_model_optimizer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wm_steps", type=int, default=2000)
    ap.add_argument("--behavior_steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--episode_len", type=int, default=12)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--eval_episodes", type=int, default=64)
    ap.add_argument("--eval_len", type=int, default=20)
    ap.add_argument("--report", default="results/torch/dreamer_rl.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _noise(seed: int, device: torch.device) -> Noise:
    return Noise(torch.Generator(device=device).manual_seed(seed))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    bank = torch.from_numpy(get_sprite_bank()).float().to(device)
    b, t = args.batch, args.episode_len

    # 1 + 2: the world model on random episodes.
    wm = WorldModel(image_shape=(64, 64, 1), cnn_depth=16, stoch=16,
                    deter=128, hidden=128, discrete=16, pred_reward=True,
                    action_dim=2,
                    generator=torch.Generator().manual_seed(1)).to(device)
    opt = world_model_optimizer(wm.parameters(), lr=3e-4)
    collect, sample = _noise(42, device), _noise(43, device)
    _sync(device)
    t0 = time.time()
    for i in range(args.wm_steps):
        ep = envs.collect_random(collect, bank, b, t)
        opt.zero_grad()
        loss, (m, _) = wm.loss(ep, sample)
        loss.backward()
        opt.step()
        m = {k: v.detach() if torch.is_tensor(v) else v for k, v in m.items()}
        if (i + 1) % 500 == 0:
            print(f"[wm {i + 1}] loss={float(m['loss']):.1f} "
                  f"image={float(m['image_loss']):.1f} "
                  f"reward={float(m['reward_loss']):.4f} "
                  f"kl={float(m['kl']):.2f}", flush=True)
    _sync(device)
    wm_seconds = time.time() - t0
    wm_final = {k: float(v) for k, v in m.items()}

    # 3: the actor-critic in imagination, the world model frozen.
    wm.requires_grad_(False)
    img_step_fn, get_feat_fn = rssm_behavior_fns(wm.dynamics)

    def reward_fn(feats, states, actions):
        return wm.reward_head(feats).float()

    beh = ImagBehavior(2, wm.feat_dim, actor_dist="tanh_normal",
                       horizon=args.horizon, units=200, layers=3,
                       actor_lr=1e-4, value_lr=3e-4,
                       imag_gradient="dynamics",
                       generator=torch.Generator().manual_seed(3)).to(device)

    @torch.no_grad()
    def start_states(noise: Noise) -> Dict[str, torch.Tensor]:
        """Posterior states of a fresh random episode, flattened to
        (B T, ...)."""
        ep = envs.collect_random(noise, bank, b, t)
        post, _ = wm.dynamics.observe(wm.encoder(ep["image"]), noise,
                                      actions=ep["action"])
        return {k: v.reshape(-1, *v.shape[2:]) for k, v in post.items()}

    starts, imagine = _noise(44, device), _noise(45, device)
    _sync(device)
    t0 = time.time()
    for i in range(args.behavior_steps):
        bm = beh.train_step(start_states(starts), img_step_fn, get_feat_fn,
                            reward_fn, imagine)
        if (i + 1) % 150 == 0:
            print(f"[behavior {i + 1}] imag_reward="
                  f"{float(bm['reward_mean']):.3f} "
                  f"value_loss={float(bm['value_loss']):.4f} "
                  f"actor_ent={float(bm['actor_ent']):.2f}", flush=True)
    _sync(device)
    behavior_seconds = time.time() - t0

    # 4: both policies in the environment, from the same draws.
    @torch.no_grad()
    def run_eval(mode: str) -> float:
        noise = _noise(100, device)
        n = args.eval_episodes
        env_state = envs.reset(noise, bank, n)
        state = wm.dynamics.initial(n, device)
        prev_action = torch.zeros((n, 2), device=device)
        rewards = []
        for _ in range(args.eval_len):
            obs = envs.render(env_state, bank)
            embed = wm.encoder(obs[:, None])[:, 0]
            state, _ = wm.dynamics.obs_step(state, embed, noise,
                                            action=prev_action)
            if mode == "actor":
                action = beh.actor.mode(beh.actor(
                    wm.dynamics.get_feat(state)))
            else:
                action = noise.uniform((n, 2), device, -1.0, 1.0)
            env_state, reward = envs.step(env_state, action)
            rewards.append(reward)
            prev_action = action
        return float(torch.stack(rewards).mean())

    actor_reward, random_reward = run_eval("actor"), run_eval("random")
    print(f"eval mean reward: actor={actor_reward:.3f} "
          f"random={random_reward:.3f}")
    report = {
        "env": "ControlledDigit (wm/envs.py)",
        "wm_steps": args.wm_steps, "wm_seconds": round(wm_seconds, 1),
        "wm_final": wm_final,
        "behavior_steps": args.behavior_steps,
        "behavior_seconds": round(behavior_seconds, 1),
        "imag_reward_final": (float(bm["reward_mean"])
                              if args.behavior_steps else float("nan")),
        "eval_mean_reward_actor": actor_reward,
        "eval_mean_reward_random": random_reward,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "note": ("full Dreamer RL loop (collect -> action-conditioned "
                 "world model -> imagination-trained actor-critic -> "
                 "env eval), PyTorch port"),
    }
    path = pathlib.Path(args.report)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2) + "\n")
    print(f"report → {path}")
    return report


if __name__ == "__main__":
    main()
