"""Process launcher — ``python -m paddle_tpu_torch.distributed.launch``
(the port of ``paddle_tpu/distributed/launch``).

It starts ``--nproc_per_node`` processes of a training script, one a
rank, each with the rank's environment contract, and writes each
process's output to ``<log_dir>/workerlog.<rank>``:

  PADDLE_TRAINER_ID        global rank
  PADDLE_TRAINERS_NUM      world size
  PADDLE_LOCAL_RANK        rank within this node
  PADDLE_NPROC_PER_NODE    ranks on this node
  PADDLE_MASTER            rendezvous host:port
  PADDLE_MASTER_HOSTED     ``1`` when the launcher itself hosts the
                           rendezvous store at PADDLE_MASTER (every
                           rank then connects as a client)
  PADDLE_TRAINER_ENDPOINTS comma list of worker endpoints
  PADDLE_DIST_BACKEND      ``nccl`` or ``gloo`` (``--backend``; unset:
                           ``init_parallel_env`` chooses)
  PADDLE_DIST_DEVICE       ``cpu`` or ``cuda`` (``--device``)
  PADDLE_RESTART_ATTEMPT   0, then 1, 2, ... after each relaunch

Without ``--master`` the launcher binds the rendezvous ``TCPStore`` on
port 0 itself, before any rank starts, and passes the bound port on: no
port is picked by binding and releasing it, so no other process can take
it between the pick and the world's bind.  The endpoint ports are held
bound by the launcher for its whole run for the same reason.  Each
relaunch rendezvouses under its own key prefix
(``attempt_<PADDLE_RESTART_ATTEMPT>/``) in that one store.

``init_parallel_env()`` reads the contract.  The first rank that fails
ends the others and gives the launcher its exit code; with
``--max_restarts N`` a failed world (a rank exiting with
``ELASTIC_EXIT_CODE`` 101 or crashing) is relaunched up to N times.
"""
from .main import ELASTIC_EXIT_CODE, launch, main

__all__ = ["launch", "main", "ELASTIC_EXIT_CODE"]
