#!/bin/sh
# Print what the machine offers for SSH dispatch: the card, the Python
# packages the transports use, the OpenSSH binaries and the login.
# Run from the checkout: sh tools/ssh_stack_probe.sh
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for m in cryptography zstandard asyncssh cloudpickle; do python3 -c "import $m; print('$m', getattr($m,'__version__','?'))" 2>&1 | tail -1; done
echo "command -v:"; for b in ssh sshd scp ssh-keygen; do printf '%s=%s\n' $b "$(command -v $b)"; done
ls /usr/sbin/sshd 2>&1
echo "uid=$(id -u) user=$(id -un 2>&1) HOME=$HOME"
hostname; python3 -c 'import socket; print(socket.gethostname())'
python3 -c 'import getpass; print(getpass.getuser())' 2>&1
nproc
