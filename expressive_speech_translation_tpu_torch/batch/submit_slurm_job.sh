#!/bin/bash
# SLURM array driver (parity: Batch-Processing/submit_slurm_job.sh:2-10 —
# array 1-400%10, 1 GPU/16GB/4 CPU per task; here: 1 GPU per task).
#
# Usage: sbatch submit_slurm_job.sh MANIFEST.csv OUTPUT_DIR [TARGET_LANG]
#
#SBATCH --job-name=est-torch-batch
#SBATCH --array=1-400%10
#SBATCH --gres=gpu:1
#SBATCH --cpus-per-task=4
#SBATCH --mem=16G
#SBATCH --time=02:00:00
#SBATCH --output=logs/batch_%A_%a.out

set -euo pipefail

MANIFEST=${1:?manifest csv required}
OUTPUT_DIR=${2:?output dir required}
TARGET_LANG=${3:-fra}

python -m expressive_speech_translation_tpu_torch.batch.runner \
    "${OUTPUT_DIR}" \
    --manifest "${MANIFEST}" \
    --row "${SLURM_ARRAY_TASK_ID}" \
    --lang "${TARGET_LANG}"
