"""Rendering — the reference's matplotlib HUD (pogostick_v1_env.py:556-620)
plus an ``rgb_array`` mode the reference lacks (needed for headless eval and
video capture)."""

from __future__ import annotations

import numpy as np


def render_env(env, mode="human", title=None):
    from ..utils.extras import require
    matplotlib = require("matplotlib", "render")
    if mode == "rgb_array":
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    color_map = "gist_ncar"
    if title is None:
        title = env.env_id

    r, c = env.agent_location
    x2, y2 = {"NORTH": (0, -0.01), "SOUTH": (0, 0.01),
              "WEST": (-0.01, 0), "EAST": (0.01, 0)}[env.agent_facing_str]

    fig = plt.figure(title, figsize=(9, 5))
    plt.imshow(env.map, cmap=color_map, vmin=0, vmax=len(env.items_id))
    plt.arrow(c, r, x2, y2, head_width=0.7, head_length=0.7, color="white")
    plt.title("NORTH", fontsize=10)
    plt.xlabel("SOUTH")
    plt.ylabel("WEST")
    plt.text(env.map_size, env.map_size // 2, "EAST", rotation=90)

    last_action = env.last_action if isinstance(env.last_action, str) else \
        env.action_str.get(int(env.last_action), str(env.last_action))
    info = "\n".join(["               Info:             ",
                      "Steps: " + str(env.step_count),
                      "Agent Facing: " + env.agent_facing_str,
                      "Action: " + last_action,
                      "Selected item: " + getattr(env, "selected_item", ""),
                      "Reward: " + str(env.last_reward),
                      "Step Cost: " + str(env.last_step_cost),
                      "Done: " + str(env.last_done)])
    props = dict(boxstyle="round", facecolor="w", alpha=0.2)
    plt.text(-(env.map_size // 2) - 0.5, 2.25, info, fontsize=10, bbox=props)

    goal = env.goal_item_to_craft
    if env.last_done and goal:
        if env.inventory_items_quantity.get(goal, 0) >= 1:
            msg = ("YOU WIN " + env.env_id + "!!!"
                   + "\nYOU CRAFTED " + goal.upper() + "!!!")
        else:
            msg = "YOU CAN'T WIN " + env.env_id + "!!!"
        plt.text(-0.1, env.map_size // 2, msg, fontsize=18,
                 bbox=dict(boxstyle="round", facecolor="w", alpha=1))

    cmap = matplotlib.colormaps.get_cmap(color_map)
    legend_elements = [
        Line2D([0], [0], marker="^", color="w", label="agent",
               markerfacecolor="w", markersize=12, markeredgewidth=2,
               markeredgecolor="k"),
        Line2D([0], [0], color="w", label="INVENTORY:"),
    ]
    inv = env.inventory_items_quantity
    for item in sorted(inv):
        rgba = cmap(env.items_id[item] / len(env.items_id))
        legend_elements.append(
            Line2D([0], [0], marker="s", color="w",
                   label=f"{item}: {inv[item]}", markerfacecolor=rgba,
                   markersize=16))
    plt.legend(handles=legend_elements, bbox_to_anchor=(1.55, 1.02))
    plt.tight_layout()

    if mode == "rgb_array":
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return buf
    plt.pause(0.01)
    plt.clf()
    return None
