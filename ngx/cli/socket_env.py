"""JSON-over-TCP env server — wire-compatible with the reference's
``tests/socket_env.py:23-51`` demo (action name in, ``{'observation',
'reward', 'done'}`` JSON out, one client, port 9000).

    python -m ngx.cli.socket_env -env NovelGridworld-v6 -port 9000
"""

from __future__ import annotations

import argparse
import json
import socket

from . import PLATFORMS, set_platform


def recv_socket_data(sock, buff=4096):
    data = b""
    while True:
        part = sock.recv(buff)
        data += part
        if len(part) < buff:
            break
    return data


def serve(env, host="127.0.0.1", port=9000, render=False, max_steps=None):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen()
    print(f"serving {env.env_id} on {host}:{port}")
    conn, addr = sock.accept()
    print("Connected with agent: ", addr)

    env.reset()
    steps = 0
    try:
        while max_steps is None or steps < max_steps:
            action = recv_socket_data(conn).decode().strip()
            if not action:
                break
            action_id = env.actions_id[action]
            obs, reward, done, info = env.step(action_id)
            msg = {"observation": str(obs), "reward": reward, "done": done}
            conn.sendall(str.encode(json.dumps(msg) + "\n"))
            if render:
                env.render()
            steps += 1
    finally:
        conn.close()
        sock.close()
        env.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-v6")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9000)
    p.add_argument("-render", action="store_true")
    p.add_argument("-max_steps", type=int, default=None)
    p.add_argument("-platform", default="cpu", choices=PLATFORMS,
                   help="single-env driver: every step is one host "
                        "round-trip, which the host CPU answers faster "
                        "than a device launch (default cpu)")
    args = p.parse_args(argv)

    set_platform(args.platform)
    import ngx.compat as C
    serve(C.make(args.env), args.host, args.port, args.render, args.max_steps)


if __name__ == "__main__":
    main()
