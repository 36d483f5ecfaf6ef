"""Admin shell: cluster maintenance commands (ref: weed/shell/).

Commands are async callables `cmd(env, args) -> str` registered in COMMANDS;
mutating commands must hold the cluster-wide exclusive admin lease
(ref: weed/shell/commands.go:71-78). The port's command table is in
shell/commands.py.
"""

from .command_env import CommandEnv
from .commands import COMMANDS, run_command

__all__ = ["CommandEnv", "COMMANDS", "run_command"]
