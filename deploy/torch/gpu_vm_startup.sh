#!/bin/bash
# H100 GPU-VM provisioning for the cuking_tpu_torch image (reference:
# instance_startup_script.sh:1-25, which set up an A100 VM with driver 515.57,
# nvidia-docker2 and the Cloud Ops agent).
#
# Use as --metadata startup-script for Ubuntu GPU VMs (e.g. a3-highgpu-1g)
# created outside Cloud Batch; Batch-managed instances are configured by
# cuking_tpu_torch/cloud/batch_submit.py instead (installGpuDrivers).
# Then: docker run --gpus all <image> --input_uri=... --output_uri=...

set -euo pipefail
export DEBIAN_FRONTEND=noninteractive

# Cloud Ops agent for system metrics + log routing (mirrors
# instance_startup_script.sh:5-8).
curl -sSO https://dl.google.com/cloudagents/add-google-cloud-ops-agent-repo.sh
bash add-google-cloud-ops-agent-repo.sh --also-install

# NVIDIA driver.  The image is built on CUDA 12.8 (deploy/torch/Dockerfile),
# which needs the 570 branch or newer; Hopper takes the open kernel modules.
apt-get update
apt-get install -y --no-install-recommends nvidia-driver-570-server-open
# Multi-GPU H100 machine types join their cards through NVSwitch, which needs
# the fabric manager of the same branch.
if lspci -d 10de: | grep -qi bridge; then
  apt-get install -y --no-install-recommends nvidia-fabricmanager-570
  systemctl enable --now nvidia-fabricmanager
fi

# Docker and the NVIDIA container toolkit (the successor of nvidia-docker2),
# so containers can take --gpus all.
apt-get install -y --no-install-recommends docker.io gnupg
curl -fsSL https://nvidia.github.io/libnvidia-container/gpgkey |
  gpg --dearmor --yes -o /usr/share/keyrings/nvidia-container-toolkit-keyring.gpg
curl -fsSL https://nvidia.github.io/libnvidia-container/stable/deb/nvidia-container-toolkit.list |
  sed 's#deb https://#deb [signed-by=/usr/share/keyrings/nvidia-container-toolkit-keyring.gpg] https://#g' \
    > /etc/apt/sources.list.d/nvidia-container-toolkit.list
apt-get update
apt-get install -y --no-install-recommends nvidia-container-toolkit
nvidia-ctk runtime configure --runtime=docker
systemctl restart docker

# Docker auth for Artifact Registry pulls (instance_startup_script.sh:23-25).
yes | gcloud auth configure-docker us-central1-docker.pkg.dev
