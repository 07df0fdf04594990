"""Reproducibility: the git status and diff of the registered repos
(counterpart of ``rsl_rl_tpu/utils/git_state.py``), through the ``git``
command line.
"""

from __future__ import annotations

import os
import pathlib
import subprocess


def _git(repo_dir: str, *args: str) -> str:
    return subprocess.run(
        ["git", "-C", repo_dir, *args], capture_output=True, text=True, check=True
    ).stdout


def store_code_state(logdir: str, repositories: list[str]) -> list[str]:
    """Write ``<logdir>/git/<repo>.diff`` files with status + working diff."""
    git_log_dir = os.path.join(logdir, "git")
    os.makedirs(git_log_dir, exist_ok=True)
    file_paths = []
    for repository_file_path in repositories:
        start = repository_file_path
        if os.path.isfile(start):
            start = os.path.dirname(start)
        try:
            toplevel = _git(start, "rev-parse", "--show-toplevel").strip()
        except (subprocess.CalledProcessError, FileNotFoundError):
            print(f"Could not find git repository in {repository_file_path}. Skipping.")
            continue
        repo_name = pathlib.Path(toplevel).name
        diff_file_name = os.path.join(git_log_dir, f"{repo_name}.diff")
        if os.path.isfile(diff_file_name):
            continue
        try:
            status = _git(toplevel, "status")
            diff = _git(toplevel, "diff", "HEAD")
        except subprocess.CalledProcessError:
            continue
        print(f"Storing git diff for '{repo_name}' in: {diff_file_name}")
        with open(diff_file_name, "x", encoding="utf-8") as f:
            f.write(f"--- git status ---\n{status} \n\n\n--- git diff ---\n{diff}")
        file_paths.append(diff_file_name)
    return file_paths
