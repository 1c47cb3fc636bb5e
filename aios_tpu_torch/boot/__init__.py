"""Boot layer: config, hardware detection, topo-sorted service supervision.

Reference: initd/ (PID-1 aios-init, SURVEY.md section 2 row 1). On a TPU-VM
deployment this runs as an ordinary supervisor process rather than PID 1 —
the QEMU/ISO path of the reference is replaced by TPU-VM host provisioning
(scripts/deploy-tpu-vm.sh).
"""
