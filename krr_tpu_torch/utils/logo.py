"""ASCII banner printed at startup (reference prints its own logo,
`robusta_krr/utils/logo.py`)."""

ASCII_LOGO = r"""
[bold magenta]
  _  __ ___  ___      _____ ___ _   _
 | |/ /| _ \| _ \ ___|_   _| _ \ | | |
 | ' < |   /|   /|___| | | |  _/ |_| |
 |_|\_\|_|_\|_|_\      |_| |_|  \___/
[/bold magenta]
[dim]Kubernetes Resource Recommender — PyTorch/CUDA port[/dim]
"""
