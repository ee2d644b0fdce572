"""Browser-tier thin volunteer — the paper's design point as a client shape.

JSDoop's volunteers are web pages: they arrive over WebSocket, lease work,
fetch the latest model, and push one small gradient per task — they never
upload a full model, because a browser tab on hotel wifi cannot pay the
model push per update (MLitB's thin-client stance; the server-side applier
PR 5 built is the other half of that contract).

``BrowserClient`` is that volunteer: ``WsClientTransport`` (RFC 6455
framing, the only dialect a browser's ``WebSocket`` object speaks) driving
the stock ``run_volunteer`` loop under a **barrierless** policy, so every
commit rides one ``SubmitUpdate`` frame. The thin-client contract is
enforced twice:

- at construction: a barrier policy (sync BSP) is refused outright — it
  would require the volunteer to fetch-at-admission and push the reduced
  model, exactly the bytes a browser must not pay;
- after the run: the transport's request histogram must contain ZERO
  ``PublishModel`` frames, or ``run()`` raises.

``python -m repro_torch.core.browser --port P --policy staleness:2`` is the CLI
used by the gateway's ``--smoke`` browser leg and the README quickstart.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple

from repro_torch.core.aggregation import PolicyLike, make_policy
from repro_torch.core.gateway import WsClientTransport, run_volunteer


class BrowserClient:
    """A browser-shaped volunteer: WebSocket framing, barrierless policy,
    zero model pushes — lease, fetch-latest, ``SubmitUpdate``, repeat."""

    def __init__(self, host: str, port: int, vid: str, *,
                 policy: PolicyLike, connect_timeout: float = 10.0,
                 task_delay: float = 0.0):
        self.policy = make_policy(policy)
        if self.policy.barrier:
            raise ValueError(
                f"BrowserClient needs a barrierless policy (staleness:<s> "
                f"or local:<k>), got {self.policy.spec!r}: a barrier policy "
                f"makes the volunteer push reduced models, which the "
                f"browser tier never does")
        self.vid = vid
        self.task_delay = task_delay
        self.transport = WsClientTransport(host, port, vid,
                                           connect_timeout=connect_timeout)

    def run(self, n_updates: int) -> Tuple[int, int]:
        """Volunteer until the run reaches ``n_updates`` committed versions.
        Returns (final_version, tasks_done); raises if the thin-client
        contract was broken (any PublishModel frame on the wire)."""
        final, tasks = run_volunteer(
            self.transport, self.vid, n_updates, policy=self.policy,
            task_delay=self.task_delay)
        pushed = self.transport.sent.get("PublishModel", 0)
        if pushed:
            raise RuntimeError(
                f"browser thin-client contract broken: {pushed} "
                f"PublishModel frame(s) sent ({self.transport.sent})")
        return final, tasks

    def close(self) -> None:
        self.transport.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--vid", default="browser0")
    ap.add_argument("--policy", default="staleness:2",
                    help="barrierless only: staleness:<s> | local:<k>")
    ap.add_argument("--n-versions", type=int, default=4)
    ap.add_argument("--n-mb", type=int, default=6)
    ap.add_argument("--task-delay", type=float, default=0.0)
    ap.add_argument("--expect-final", type=int, default=None)
    args = ap.parse_args(argv)
    from repro_torch.core.simulator import SyntheticProblem
    problem = SyntheticProblem(n_versions=args.n_versions, n_mb=args.n_mb)
    policy = make_policy(args.policy)
    n_updates = policy.n_updates(problem, args.n_versions)
    client = BrowserClient(args.host, args.port, args.vid, policy=policy,
                           task_delay=args.task_delay)
    try:
        final, tasks = client.run(n_updates)
    finally:
        client.close()
    sent = dict(client.transport.sent)
    print(f"browser {args.vid} [ws]: final_version={final} tasks={tasks} "
          f"submit_updates={sent.get('SubmitUpdate', 0)} "
          f"publish_models={sent.get('PublishModel', 0)}", flush=True)
    if args.expect_final is not None and final != args.expect_final:
        print(f"FAIL: expected final_version={args.expect_final}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
