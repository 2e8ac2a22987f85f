"""The scheduler seam's protobuf messages, in the port's own descriptor
pool.

The serialized ``FileDescriptorProto`` below is the reference's
(``protocol_tpu/proto/scheduler_pb2.py``, from ``scheduler.proto``), byte
for byte: the file name ``protocol_tpu/proto/scheduler.proto``, the
package ``protocol_tpu.scheduler.v1`` and the service name are the wire
contract. It is added to a private ``DescriptorPool``, not protobuf's
default one, so that this module and the reference's can be imported in
one process (the default pool refuses a second file of the same name);
messages from either serialize to the same bytes and parse the other's.
"""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import message_factory as _message_factory

_SERIALIZED = (
    b'\n"protocol_tpu/proto/scheduler.proto\x12\x19protocol_tpu.scheduler.v1"\xf2\x01\n\rP'
    b'roviderBatch\x12\x11\n\tgpu_count\x18\x01 \x03(\x05\x12\x12\n\ngpu_mem_mb\x18\x02 '
    b'\x03(\x05\x12\x14\n\x0cgpu_model_id\x18\x03 \x03(\x05\x12\x0f\n\x07has_gpu\x18\x04 '
    b'\x03(\x08\x12\x0f\n\x07has_cpu\x18\x05 \x03(\x08\x12\x11\n\tcpu_cores\x18\x06 \x03('
    b'\x05\x12\x0e\n\x06ram_mb\x18\x07 \x03(\x05\x12\x12\n\nstorage_gb\x18\x08 \x03(\x05'
    b'\x12\x0b\n\x03lat\x18\t \x03(\x02\x12\x0b\n\x03lon\x18\n \x03(\x02\x12\x14\n\x0chas_'
    b'location\x18\x0b \x03(\x08\x12\r\n\x05price\x18\x0c \x03(\x02\x12\x0c\n\x04load\x18'
    b'\r \x03(\x02"\x90\x03\n\x10RequirementBatch\x12\x14\n\x0ccpu_required\x18\x01 \x03('
    b'\x08\x12\x11\n\tcpu_cores\x18\x02 \x03(\x05\x12\x0e\n\x06ram_mb\x18\x03 \x03(\x05'
    b'\x12\x12\n\nstorage_gb\x18\x04 \x03(\x05\x12\x17\n\x0fmax_gpu_options\x18\x05 \x01('
    b'\r\x12\x13\n\x0bmodel_words\x18\x06 \x01(\r\x12\x15\n\rgpu_opt_valid\x18\x07 \x03('
    b'\x08\x12\x11\n\tgpu_count\x18\x08 \x03(\x05\x12\x13\n\x0bgpu_mem_min\x18\t \x03(\x05'
    b'\x12\x13\n\x0bgpu_mem_max\x18\n \x03(\x05\x12\x19\n\x11gpu_total_mem_min\x18\x0b '
    b'\x03(\x05\x12\x19\n\x11gpu_total_mem_max\x18\x0c \x03(\x05\x12\x16\n\x0egpu_model_ma'
    b'sk\x18\r \x03(\r\x12\x1d\n\x15gpu_model_constrained\x18\x0e \x03(\x08\x12\x0b\n\x03l'
    b'at\x18\x0f \x03(\x02\x12\x0b\n\x03lon\x18\x10 \x03(\x02\x12\x14\n\x0chas_location'
    b'\x18\x11 \x03(\x08\x12\x10\n\x08priority\x18\x12 \x03(\x02"O\n\x0bCostWeights\x12\r'
    b'\n\x05price\x18\x01 \x01(\x02\x12\x0c\n\x04load\x18\x02 \x01(\x02\x12\x11\n\tproximi'
    b'ty\x18\x03 \x01(\x02\x12\x10\n\x08priority\x18\x04 \x01(\x02"\xbb\x02\n\rAssignReque'
    b'st\x12;\n\tproviders\x18\x01 \x01(\x0b2(.protocol_tpu.scheduler.v1.ProviderBatch\x12'
    b'A\n\x0crequirements\x18\x02 \x01(\x0b2+.protocol_tpu.scheduler.v1.RequirementBatch'
    b'\x127\n\x07weights\x18\x03 \x01(\x0b2&.protocol_tpu.scheduler.v1.CostWeights\x12\x0e'
    b'\n\x06kernel\x18\x04 \x01(\t\x12\r\n\x05top_k\x18\x05 \x01(\r\x12\x0b\n\x03eps\x18'
    b'\x06 \x01(\x02\x12\x11\n\tmax_iters\x18\x07 \x01(\r\x12\x12\n\nwarm_price\x18\x08 '
    b'\x03(\x02\x12\x1e\n\x16seed_provider_for_task\x18\t \x03(\x05"}\n\x0eAssignResponse'
    b'\x12\x19\n\x11provider_for_task\x18\x01 \x03(\x05\x12\x19\n\x11task_for_provider\x18'
    b'\x02 \x03(\x05\x12\x14\n\x0cnum_assigned\x18\x03 \x01(\r\x12\x10\n\x08solve_ms\x18'
    b'\x04 \x01(\x02\x12\r\n\x05price\x18\x05 \x03(\x02"\x0f\n\rHealthRequest"\x87\x01\n'
    b'\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x10\n\x08platform\x18\x02'
    b' \x01(\t\x12\x14\n\x0cdevice_count\x18\x03 \x01(\r\x12=\n\x0cseam_metrics\x18\x04 '
    b'\x03(\x0b2\'.protocol_tpu.scheduler.v1.MetricSample"8\n\nTensorBlob\x12\x0c\n\x04dat'
    b'a\x18\x01 \x01(\x0c\x12\r\n\x05dtype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03('
    b'\x03"R\n\x0bNamedTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x125\n\x06tensor\x18\x02 '
    b'\x01(\x0b2%.protocol_tpu.scheduler.v1.TensorBlob"J\n\x0fProviderBatchV2\x127\n\x07co'
    b'lumns\x18\x01 \x03(\x0b2&.protocol_tpu.scheduler.v1.NamedTensor"M\n\x12RequirementBa'
    b'tchV2\x127\n\x07columns\x18\x01 \x03(\x0b2&.protocol_tpu.scheduler.v1.NamedTensor"'
    b'\xbd\x03\n\x0fAssignRequestV2\x12=\n\tproviders\x18\x01 \x01(\x0b2*.protocol_tpu.sch'
    b'eduler.v1.ProviderBatchV2\x12C\n\x0crequirements\x18\x02 \x01(\x0b2-.protocol_tpu.sc'
    b'heduler.v1.RequirementBatchV2\x127\n\x07weights\x18\x03 \x01(\x0b2&.protocol_tpu.sch'
    b'eduler.v1.CostWeights\x12\x0e\n\x06kernel\x18\x04 \x01(\t\x12\r\n\x05top_k\x18\x05 '
    b'\x01(\r\x12\x0b\n\x03eps\x18\x06 \x01(\x02\x12\x11\n\tmax_iters\x18\x07 \x01(\r\x129'
    b'\n\nwarm_price\x18\x08 \x01(\x0b2%.protocol_tpu.scheduler.v1.TensorBlob\x12E\n\x16se'
    b'ed_provider_for_task\x18\t \x01(\x0b2%.protocol_tpu.scheduler.v1.TensorBlob\x12\x13'
    b'\n\x0bstream_mode\x18\n \x01(\x08\x12\x17\n\x0freconcile_every\x18\x0b \x01(\r"\x87'
    b'\x02\n\x10AssignResponseV2\x12@\n\x11provider_for_task\x18\x01 \x01(\x0b2%.protocol_'
    b'tpu.scheduler.v1.TensorBlob\x12@\n\x11task_for_provider\x18\x02 \x01(\x0b2%.protocol'
    b'_tpu.scheduler.v1.TensorBlob\x12\x14\n\x0cnum_assigned\x18\x03 \x01(\r\x12\x10\n\x08'
    b'solve_ms\x18\x04 \x01(\x02\x124\n\x05price\x18\x05 \x01(\x0b2%.protocol_tpu.schedule'
    b'r.v1.TensorBlob\x12\x11\n\tdecode_ms\x18\x06 \x01(\x02"s\n\rSnapshotChunk\x12\x12\n'
    b'\nsession_id\x18\x01 \x01(\t\x12\x19\n\x11epoch_fingerprint\x18\x02 \x01(\t\x12\x0f'
    b'\n\x07payload\x18\x03 \x01(\x0c\x12\r\n\x05codec\x18\x04 \x01(\t\x12\x13\n\x0btotal_'
    b'bytes\x18\x05 \x01(\x04"\x9c\x01\n\x13OpenSessionResponse\x12\n\n\x02ok\x18\x01 \x01'
    b'(\x08\x12\r\n\x05error\x18\x02 \x01(\t\x12\x12\n\nsession_id\x18\x03 \x01(\t\x12\x19'
    b'\n\x11epoch_fingerprint\x18\x04 \x01(\t\x12;\n\x06result\x18\x05 \x01(\x0b2+.protoco'
    b'l_tpu.scheduler.v1.AssignResponseV2"\x8a\x03\n\x12AssignDeltaRequest\x12\x12\n\nsess'
    b'ion_id\x18\x01 \x01(\t\x12\x19\n\x11epoch_fingerprint\x18\x02 \x01(\t\x12\x0c\n\x04t'
    b'ick\x18\x03 \x01(\x04\x12<\n\rprovider_rows\x18\x04 \x01(\x0b2%.protocol_tpu.schedul'
    b'er.v1.TensorBlob\x12=\n\tproviders\x18\x05 \x01(\x0b2*.protocol_tpu.scheduler.v1.Pro'
    b'viderBatchV2\x128\n\ttask_rows\x18\x06 \x01(\x0b2%.protocol_tpu.scheduler.v1.TensorB'
    b'lob\x12C\n\x0crequirements\x18\x07 \x01(\x0b2-.protocol_tpu.scheduler.v1.Requirement'
    b'BatchV2\x12\x14\n\x0cevent_source\x18\x08 \x01(\t\x12\x11\n\tevent_seq\x18\t \x01('
    b'\x04\x12\x12\n\nevent_kind\x18\n \x01(\t"\x90\x02\n\x13AssignDeltaResponse\x12\x12\n'
    b'\nsession_ok\x18\x01 \x01(\x08\x12\r\n\x05error\x18\x02 \x01(\t\x12;\n\x06result\x18'
    b'\x03 \x01(\x0b2+.protocol_tpu.scheduler.v1.AssignResponseV2\x12\r\n\x05stale\x18\x04'
    b' \x01(\x08\x12\x17\n\x0fstaleness_ticks\x18\x05 \x01(\r\x12\x10\n\x08replayed\x18'
    b'\x06 \x01(\x08\x12\x15\n\revent_deduped\x18\x07 \x01(\x08\x12\x12\n\nreconciled\x18'
    b'\x08 \x01(\x08\x12\x14\n\x0cgap_per_task\x18\t \x01(\x02\x12\x1e\n\x16events_since_r'
    b'econcile\x18\n \x01(\r"+\n\x0cMetricSample\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n'
    b'\x05value\x18\x02 \x01(\x01"V\n\x0eMigrateRequest\x12\x17\n\x0ftarget_endpoint\x18'
    b'\x01 \x01(\t\x12\x16\n\x0etarget_proc_id\x18\x02 \x01(\t\x12\x13\n\x0bsession_ids'
    b'\x18\x03 \x03(\t";\n\x0fMigrateResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05e'
    b'rror\x18\x02 \x01(\t\x12\r\n\x05moved\x18\x03 \x01(\r2\xf0\x04\n\x10SchedulerBackend'
    b'\x12]\n\x06Assign\x12(.protocol_tpu.scheduler.v1.AssignRequest\x1a).protocol_tpu.sch'
    b'eduler.v1.AssignResponse\x12]\n\x06Health\x12(.protocol_tpu.scheduler.v1.HealthReque'
    b'st\x1a).protocol_tpu.scheduler.v1.HealthResponse\x12c\n\x08AssignV2\x12*.protocol_tp'
    b'u.scheduler.v1.AssignRequestV2\x1a+.protocol_tpu.scheduler.v1.AssignResponseV2\x12i'
    b'\n\x0bOpenSession\x12(.protocol_tpu.scheduler.v1.SnapshotChunk\x1a..protocol_tpu.sch'
    b'eduler.v1.OpenSessionResponse(\x01\x12l\n\x0bAssignDelta\x12-.protocol_tpu.scheduler'
    b'.v1.AssignDeltaRequest\x1a..protocol_tpu.scheduler.v1.AssignDeltaResponse\x12`\n\x07'
    b'Migrate\x12).protocol_tpu.scheduler.v1.MigrateRequest\x1a*.protocol_tpu.scheduler.v1'
    b'.MigrateResponseb\x06proto3'
)

POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = POOL.AddSerializedFile(_SERIALIZED)

for _name, _desc in DESCRIPTOR.message_types_by_name.items():
    globals()[_name] = _message_factory.GetMessageClass(_desc)
del _name, _desc
