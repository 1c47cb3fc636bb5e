# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: orchestrator.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import common_pb2 as common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12orchestrator.proto\x12\x11\x61ios.orchestrator\x1a\x0c\x63ommon.proto\"o\n\x11SubmitGoalRequest\x12\x13\n\x0b\x64\x65scription\x18\x01 \x01(\t\x12\x10\n\x08priority\x18\x02 \x01(\x05\x12\x0e\n\x06source\x18\x03 \x01(\t\x12\x0c\n\x04tags\x18\x04 \x03(\t\x12\x15\n\rmetadata_json\x18\x05 \x01(\x0c\"\x88\x01\n\x12GoalStatusResponse\x12\x1f\n\x04goal\x18\x01 \x01(\x0b\x32\x11.aios.common.Goal\x12 \n\x05tasks\x18\x02 \x03(\x0b\x32\x11.aios.common.Task\x12\x15\n\rcurrent_phase\x18\x03 \x01(\t\x12\x18\n\x10progress_percent\x18\x04 \x01(\x01\"H\n\x10ListGoalsRequest\x12\x15\n\rstatus_filter\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\x05\x12\x0e\n\x06offset\x18\x03 \x01(\x05\"C\n\x10GoalListResponse\x12 \n\x05goals\x18\x01 \x03(\x0b\x32\x11.aios.common.Goal\x12\r\n\x05total\x18\x02 \x01(\x05\"y\n\x10HeartbeatRequest\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\x17\n\x0f\x63urrent_task_id\x18\x03 \x01(\t\x12\x11\n\tcpu_usage\x18\x04 \x01(\x01\x12\x17\n\x0fmemory_usage_mb\x18\x05 \x01(\x01\"C\n\x11\x41gentListResponse\x12.\n\x06\x61gents\x18\x01 \x03(\x0b\x32\x1e.aios.common.AgentRegistration\"\xe7\x01\n\x14SystemStatusResponse\x12\x14\n\x0c\x61\x63tive_goals\x18\x01 \x01(\x05\x12\x15\n\rpending_tasks\x18\x02 \x01(\x05\x12\x15\n\ractive_agents\x18\x03 \x01(\x05\x12\x15\n\rloaded_models\x18\x04 \x03(\t\x12\x13\n\x0b\x63pu_percent\x18\x05 \x01(\x01\x12\x16\n\x0ememory_used_mb\x18\x06 \x01(\x01\x12\x17\n\x0fmemory_total_mb\x18\x07 \x01(\x01\x12\x16\n\x0e\x61utonomy_level\x18\x08 \x01(\t\x12\x16\n\x0euptime_seconds\x18\t \x01(\x03\"c\n\x11\x43\x61pabilityRequest\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\t\x12\x14\n\x0c\x63\x61pabilities\x18\x02 \x03(\t\x12\x0e\n\x06reason\x18\x03 \x01(\t\x12\x16\n\x0e\x64uration_hours\x18\x04 \x01(\x03\"f\n\x12\x43\x61pabilityResponse\x12\x0f\n\x07granted\x18\x01 \x01(\x08\x12\x14\n\x0c\x63\x61pabilities\x18\x02 \x03(\t\x12\x12\n\nexpires_at\x18\x03 \x01(\t\x12\x15\n\rdenial_reason\x18\x04 \x01(\t\"R\n\x14\x43\x61pabilityRevocation\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\t\x12\x14\n\x0c\x63\x61pabilities\x18\x02 \x03(\t\x12\x12\n\nrevoke_all\x18\x03 \x01(\x08\"S\n\x15\x43reateScheduleRequest\x12\x11\n\tcron_expr\x18\x01 \x01(\t\x12\x15\n\rgoal_template\x18\x02 \x01(\t\x12\x10\n\x08priority\x18\x03 \x01(\x05\"8\n\x10ScheduleResponse\x12\x13\n\x0bschedule_id\x18\x01 \x01(\t\x12\x0f\n\x07success\x18\x02 \x01(\x08\"K\n\x14ScheduleListResponse\x12\x33\n\tschedules\x18\x01 \x03(\x0b\x32 .aios.orchestrator.ScheduleEntry\"z\n\rScheduleEntry\x12\n\n\x02id\x18\x01 \x01(\t\x12\x11\n\tcron_expr\x18\x02 \x01(\t\x12\x15\n\rgoal_template\x18\x03 \x01(\t\x12\x10\n\x08priority\x18\x04 \x01(\x05\x12\x0f\n\x07\x65nabled\x18\x05 \x01(\x08\x12\x10\n\x08last_run\x18\x06 \x01(\x03\",\n\x15\x44\x65leteScheduleRequest\x12\x13\n\x0bschedule_id\x18\x01 \x01(\t\"\xdf\x01\n\x10NodeRegistration\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x03 \x01(\t\x12\x0e\n\x06\x61gents\x18\x04 \x03(\t\x12\x43\n\x08metadata\x18\x05 \x03(\x0b\x32\x31.aios.orchestrator.NodeRegistration.MetadataEntry\x12\x11\n\tmax_tasks\x18\x06 \x01(\r\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\\\n\nNodeStatus\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x11\n\tcpu_usage\x18\x02 \x01(\x01\x12\x14\n\x0cmemory_usage\x18\x03 \x01(\x01\x12\x14\n\x0c\x61\x63tive_tasks\x18\x04 \x01(\r\"(\n\x10ListNodesRequest\x12\x14\n\x0cinclude_dead\x18\x01 \x01(\x08\">\n\x10NodeListResponse\x12*\n\x05nodes\x18\x01 \x03(\x0b\x32\x1b.aios.orchestrator.NodeInfo\"\x9e\x01\n\x08NodeInfo\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x03 \x01(\t\x12\x0e\n\x06\x61gents\x18\x04 \x03(\t\x12\x11\n\tcpu_usage\x18\x05 \x01(\x01\x12\x14\n\x0cmemory_usage\x18\x06 \x01(\x01\x12\x14\n\x0c\x61\x63tive_tasks\x18\x07 \x01(\r\x12\x0f\n\x07healthy\x18\x08 \x01(\x08\x32\xae\x0b\n\x0cOrchestrator\x12G\n\nSubmitGoal\x12$.aios.orchestrator.SubmitGoalRequest\x1a\x13.aios.common.GoalId\x12K\n\rGetGoalStatus\x12\x13.aios.common.GoalId\x1a%.aios.orchestrator.GoalStatusResponse\x12\x36\n\nCancelGoal\x12\x13.aios.common.GoalId\x1a\x13.aios.common.Status\x12U\n\tListGoals\x12#.aios.orchestrator.ListGoalsRequest\x1a#.aios.orchestrator.GoalListResponse\x12\x44\n\rRegisterAgent\x12\x1e.aios.common.AgentRegistration\x1a\x13.aios.common.Status\x12<\n\x0fUnregisterAgent\x12\x14.aios.common.AgentId\x1a\x13.aios.common.Status\x12\x45\n\tHeartbeat\x12#.aios.orchestrator.HeartbeatRequest\x1a\x13.aios.common.Status\x12\x46\n\nListAgents\x12\x12.aios.common.Empty\x1a$.aios.orchestrator.AgentListResponse\x12N\n\x0fGetSystemStatus\x12\x12.aios.common.Empty\x1a\'.aios.orchestrator.SystemStatusResponse\x12:\n\x0fGetAssignedTask\x12\x14.aios.common.AgentId\x1a\x11.aios.common.Task\x12@\n\x10ReportTaskResult\x12\x17.aios.common.TaskResult\x1a\x13.aios.common.Status\x12`\n\x11RequestCapability\x12$.aios.orchestrator.CapabilityRequest\x1a%.aios.orchestrator.CapabilityResponse\x12P\n\x10RevokeCapability\x12\'.aios.orchestrator.CapabilityRevocation\x1a\x13.aios.common.Status\x12_\n\x0e\x43reateSchedule\x12(.aios.orchestrator.CreateScheduleRequest\x1a#.aios.orchestrator.ScheduleResponse\x12L\n\rListSchedules\x12\x12.aios.common.Empty\x1a\'.aios.orchestrator.ScheduleListResponse\x12O\n\x0e\x44\x65leteSchedule\x12(.aios.orchestrator.DeleteScheduleRequest\x1a\x13.aios.common.Status\x12H\n\x0cRegisterNode\x12#.aios.orchestrator.NodeRegistration\x1a\x13.aios.common.Status\x12\x43\n\rNodeHeartbeat\x12\x1d.aios.orchestrator.NodeStatus\x1a\x13.aios.common.Status\x12U\n\tListNodes\x12#.aios.orchestrator.ListNodesRequest\x1a#.aios.orchestrator.NodeListResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'orchestrator_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEREGISTRATION_METADATAENTRY._options = None
  _NODEREGISTRATION_METADATAENTRY._serialized_options = b'8\001'
  _SUBMITGOALREQUEST._serialized_start=55
  _SUBMITGOALREQUEST._serialized_end=166
  _GOALSTATUSRESPONSE._serialized_start=169
  _GOALSTATUSRESPONSE._serialized_end=305
  _LISTGOALSREQUEST._serialized_start=307
  _LISTGOALSREQUEST._serialized_end=379
  _GOALLISTRESPONSE._serialized_start=381
  _GOALLISTRESPONSE._serialized_end=448
  _HEARTBEATREQUEST._serialized_start=450
  _HEARTBEATREQUEST._serialized_end=571
  _AGENTLISTRESPONSE._serialized_start=573
  _AGENTLISTRESPONSE._serialized_end=640
  _SYSTEMSTATUSRESPONSE._serialized_start=643
  _SYSTEMSTATUSRESPONSE._serialized_end=874
  _CAPABILITYREQUEST._serialized_start=876
  _CAPABILITYREQUEST._serialized_end=975
  _CAPABILITYRESPONSE._serialized_start=977
  _CAPABILITYRESPONSE._serialized_end=1079
  _CAPABILITYREVOCATION._serialized_start=1081
  _CAPABILITYREVOCATION._serialized_end=1163
  _CREATESCHEDULEREQUEST._serialized_start=1165
  _CREATESCHEDULEREQUEST._serialized_end=1248
  _SCHEDULERESPONSE._serialized_start=1250
  _SCHEDULERESPONSE._serialized_end=1306
  _SCHEDULELISTRESPONSE._serialized_start=1308
  _SCHEDULELISTRESPONSE._serialized_end=1383
  _SCHEDULEENTRY._serialized_start=1385
  _SCHEDULEENTRY._serialized_end=1507
  _DELETESCHEDULEREQUEST._serialized_start=1509
  _DELETESCHEDULEREQUEST._serialized_end=1553
  _NODEREGISTRATION._serialized_start=1556
  _NODEREGISTRATION._serialized_end=1779
  _NODEREGISTRATION_METADATAENTRY._serialized_start=1732
  _NODEREGISTRATION_METADATAENTRY._serialized_end=1779
  _NODESTATUS._serialized_start=1781
  _NODESTATUS._serialized_end=1873
  _LISTNODESREQUEST._serialized_start=1875
  _LISTNODESREQUEST._serialized_end=1915
  _NODELISTRESPONSE._serialized_start=1917
  _NODELISTRESPONSE._serialized_end=1979
  _NODEINFO._serialized_start=1982
  _NODEINFO._serialized_end=2140
  _ORCHESTRATOR._serialized_start=2143
  _ORCHESTRATOR._serialized_end=3597
# @@protoc_insertion_point(module_scope)
